"""Cut the ISA census test fixtures out of a card run's PTX and SASS.

  python tools/isa_fixtures.py [--src chiprun_out/isa] [--out tests/data/isa]

``python3 chip_smoke.py`` writes the PTX (``nvcc -ptx``) and the SASS
(``cuobjdump -sass``) of ``core/isa/csrc/isa_cases.cu`` and of its two
built fault controls (``dead_store``, ``wrong_op``) to ``chiprun_out/isa/``.
This keeps, of each text, the module header and the kernels the CPU tests
read (``tests/test_torch_isa.py``): the copy baseline with ``add.f32`` and
``rsqrt.f32`` from the cases, ``add.f32`` from ``dead_store`` and
``rsqrt.f32`` from ``wrong_op``.  Runs anywhere; needs no toolkit.
"""
from __future__ import annotations

import argparse
import re
from pathlib import Path

KEEP = {"cases": ("isa_copy", "isa_add_f32", "isa_rsqrt_f32"),
        "dead_store": ("isa_copy", "isa_add_f32"),
        "wrong_op": ("isa_copy", "isa_rsqrt_f32")}


def cut_ptx(text: str, keep) -> str:
    """The header (up to the first entry) and the kept ``.entry`` blocks,
    each from its ``.visible .entry`` line to its closing brace."""
    starts = [m.start() for m in re.finditer(r"^\.visible \.entry ", text,
                                             re.M)]
    out = [text[:starts[0]]]
    for a, b in zip(starts, starts[1:] + [len(text)]):
        block = text[a:b]
        name = re.match(r"\.visible \.entry (\w+)", block).group(1)
        if name in keep:
            out.append(block[:block.index("\n}\n") + 3] + "\n")
    return "".join(out)


def cut_sass(text: str, keep) -> str:
    """The listing's header and the kept ``Function :`` blocks, each to
    the line before the next function."""
    lines = text.splitlines(keepends=True)
    heads = [i for i, line in enumerate(lines) if "Function :" in line]
    out = lines[:heads[0]]
    for a, b in zip(heads, heads[1:] + [len(lines)]):
        if lines[a].split("Function :")[1].strip() in keep:
            out += [line for line in lines[a:b]
                    if not line.startswith(("Fatbin", "====", "arch =",
                                            "code version", "host =",
                                            "compile_size"))]
    return "".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=Path("chiprun_out/isa"))
    ap.add_argument("--out", type=Path, default=Path("tests/data/isa"))
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    for name, keep in KEEP.items():
        for ext, cut in (("ptx", cut_ptx), ("sass", cut_sass)):
            text = (args.src / f"{name}.{ext}").read_text()
            (args.out / f"{name}.{ext}").write_text(cut(text, keep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
