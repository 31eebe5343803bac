"""PTX -> SASS instruction census: the paper's Table V on the card.

The port's counterpart of ``repro.core.isa.hlo_census``, whose text is
HLO: here the portable side is the PTX ``nvcc -ptx`` emits for a kernel and
the optimized side the SASS ``cuobjdump -sass`` reads from the library
built from the same source with the same flags (``kernels/_build.py``
``ptx``, ``build``, ``sass``).  ``census`` and ``op_mapping_table`` are
named after the reference's functions.

The counting rule:

* **PTX.** The text splits into kernels at ``.entry``; a kernel's body is
  the brace-matched block after its parameter list.  An instruction is a
  statement that ends in ``;`` inside that body.  Directives (statements
  that begin with ``.``: ``.reg``, ``.param``, ``.local``, ``.loc``,
  ``.pragma`` and the like), labels (``$L__BB0_2:``), braces and comments
  are not instructions; a guard (``@%p1``, ``@!%p1``) is not part of the
  opcode.  The opcode is the statement's first word with its modifiers, as
  ``fma.rn.f32``.
* **SASS.** The listing splits into functions at ``Function :``.  An
  instruction is an opcode line of the function (``/*00a0*/  FADD ...``);
  the trailing ``BRA`` to its own address (the self-loop after ``EXIT``)
  and ``NOP`` padding are not.  A guard (``@P0``, ``@!UP1``) is not part
  of the opcode; the opcode keeps its modifiers, as ``MUFU.RSQ``.

Only ``case_metrics`` needs the toolkit (through ``build_texts``); the
parsers read text and run anywhere.
"""
from __future__ import annotations

import re
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

SOURCE = Path(__file__).resolve().parent / "csrc" / "isa_cases.cu"
N = 64                                   # every case's input is N x N f32
# the reference's ISA_CASES (its order) -> the kernel of each case
CASES = {"add.f32": "isa_add_f32", "mul.f32": "isa_mul_f32",
         "fma.f32": "isa_fma_f32", "div.f32": "isa_div_f32",
         "rsqrt.f32": "isa_rsqrt_f32", "exp.f32": "isa_exp_f32",
         "tanh.f32": "isa_tanh_f32", "softmax.f32": "isa_softmax_f32",
         "matmul.f32": "isa_matmul_f32", "reduce.f32": "isa_reduce_f32",
         "gather": "isa_gather", "scan8": "isa_scan8"}
BASELINE = "isa_copy"                    # y = x: the scaffold every case has
# flops as the reference's census counts them: matrix products only
# (2 x M x N x K), so x @ x.T at 64 x 64 is the one case with any
CASE_FLOPS = {"matmul.f32": 2 * N ** 3}

_ENTRY = re.compile(r"\.entry\s+([\w$]+)\s*\(")
_LABEL = re.compile(r"^[A-Za-z_$%][\w$]*:\s*")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def _body(text: str, start: int) -> str:
    """The brace-matched block that opens at the first ``{`` at or after
    ``start`` (without its outer braces)."""
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return text[i + 1:j]
    raise ValueError("unbalanced braces in a PTX entry")


def ptx_statement_opcode(stmt: str) -> Optional[str]:
    """The opcode of one ``;``-terminated PTX statement (braces and
    comments already removed), or None for a directive or an empty one.
    Leading labels are dropped."""
    stmt = stmt.strip()
    while True:
        m = _LABEL.match(stmt)
        if not m:
            break
        stmt = stmt[m.end():]
    if not stmt or stmt.startswith("."):
        return None
    words = stmt.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else None


def ptx_entries(text: str) -> Dict[str, List[str]]:
    """Each ``.entry`` of a PTX module -> its instructions' opcodes, in
    order (the counting rule above)."""
    out: Dict[str, List[str]] = {}
    for m in _ENTRY.finditer(text):
        params_end = text.index(")", m.end())
        body = re.sub(r"//[^\n]*", "", _body(text, params_end))
        body = body.replace("{", " ").replace("}", " ")
        ops = [ptx_statement_opcode(s) for s in body.split(";")]
        out[m.group(1)] = [op for op in ops if op is not None]
    return out


def sass_functions(text: str) -> Dict[str, List[str]]:
    """Each ``Function :`` of a ``cuobjdump -sass`` listing -> its
    instructions' opcodes, in order (the counting rule above)."""
    out: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _SASS.search(line)
        if m is None or cur is None:
            continue
        addr, op, args = int(m.group(1), 16), m.group(2), m.group(3)
        if op == "NOP":
            continue
        if op == "BRA":
            target = re.search(r"0x([0-9a-f]+)", args)
            if target and int(target.group(1), 16) == addr:
                continue                 # the self-loop after EXIT
        cur.append(op)
    return out


def histogram(ops: List[str]) -> Dict[str, int]:
    """Opcode -> count, most frequent first (ties by opcode)."""
    return dict(sorted(Counter(ops).items(), key=lambda kv: (-kv[1], kv[0])))


def census(sass_text: str) -> Dict[str, Dict]:
    """Per SASS function: its instruction count and opcode histogram."""
    return {fn: {"n_ops": len(ops), "op_histogram": histogram(ops)}
            for fn, ops in sass_functions(sass_text).items()}


def op_mapping_table(ptx_text: str, sass_text: str) -> Dict[str, Dict]:
    """The PTX -> SASS map of every kernel in both texts: the opcode
    histograms of its PTX entry and of its SASS function, with their
    instruction counts."""
    src, dst = ptx_entries(ptx_text), sass_functions(sass_text)
    return {fn: {"ptx": histogram(src[fn]), "sass": histogram(dst[fn]),
                 "n_source_ops": len(src[fn]),
                 "n_optimized_ops": len(dst[fn])}
            for fn in src if fn in dst}


def expansion(case: Mapping[str, int], base: Mapping[str, int]
              ) -> Dict[str, int]:
    """The opcodes a case has beyond the scaffold: its counts less the
    baseline's, where more (most first)."""
    diff = {op: n - base.get(op, 0) for op, n in case.items()}
    return histogram([op for op, n in diff.items() for _ in range(n)])


def build_texts(source: Optional[str] = None, name: str = "isa_cases"
                ) -> Tuple[str, str]:
    """(PTX, SASS) of the cases' source (or ``source``, a variant of it)
    built under ``name``: one text, one set of flags.  Needs the CUDA
    toolkit (nvcc, cuobjdump)."""
    from repro_torch.kernels import _build

    text = SOURCE.read_text() if source is None else source
    return _build.ptx(name, text), _build.sass(_build.build(name, text))


@lru_cache(maxsize=None)
def _table(ptx_text: str, sass_text: str) -> Dict[str, Dict]:
    return op_mapping_table(ptx_text, sass_text)


def case_metrics(case: str, ptx_text: str, sass_text: str) -> Dict:
    """One ``isa_mapping`` cell from the two texts: the reference's keys
    (``n_source_ops``, ``n_optimized_ops``, ``top_ops``: the 3 most
    frequent SASS opcodes, ``flops``) and the port's (``ptx_ops``,
    ``sass_ops``: the full histograms; ``sass_expansion``: the SASS beyond
    the copy baseline's)."""
    table = _table(ptx_text, sass_text)
    row, base = table[CASES[case]], table[BASELINE]
    return {"n_source_ops": row["n_source_ops"],
            "n_optimized_ops": row["n_optimized_ops"],
            "top_ops": dict(list(row["sass"].items())[:3]),
            "flops": CASE_FLOPS.get(case, 0),
            "ptx_ops": row["ptx"], "sass_ops": row["sass"],
            "sass_expansion": expansion(row["sass"], base["sass"])}
