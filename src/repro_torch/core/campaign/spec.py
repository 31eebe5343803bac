"""Experiment specs and deterministic grid expansion.

An :class:`Experiment` is a *description* of a microbenchmark campaign: a
named parameter grid (dtype x op x shape x ...), the backend(s) it can run
on, a per-cell cost estimate, and a runner callable that measures exactly
one cell.  The campaign scheduler (``repro_torch.core.campaign.runner``) expands
the grid into :class:`Cell`s, skips cells a previous run already completed,
and persists every measurement through ``repro_torch.core.campaign.results``.

The grid model mirrors the paper's campaign structure (Abdelkhalik et al.,
arXiv:2208.11174): each published table is a sweep over instruction x dtype
x dependence (Tables I/II), fragment shape (Table III) or working-set size
(Table IV), so one ``Experiment`` per table reproduces the whole deliverable.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

# A cell runner measures one grid point: runner(params, quick=...) -> metrics.
CellRunner = Callable[..., Dict[str, Any]]


def _fmt_value(v: Any) -> str:
    """Canonical, filesystem/CSV-safe rendering of one grid value."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (tuple, list)):
        return "x".join(_fmt_value(x) for x in v)
    return str(v)


def cell_key(params: Mapping[str, Any]) -> str:
    """Stable identifier for a grid point: ``axis=value`` sorted by axis.

    This key is what resume-skip logic matches on across runs, so it must be
    deterministic and independent of grid declaration order.
    """
    return ",".join(f"{k}={_fmt_value(params[k])}" for k in sorted(params))


@dataclass(frozen=True)
class Cell:
    """One grid point of an experiment."""
    experiment: str
    params: Dict[str, Any]

    @property
    def key(self) -> str:
        return cell_key(self.params)


@dataclass(frozen=True)
class Experiment:
    """A named, schedulable microbenchmark campaign.

    ``grid`` maps axis name -> sequence of values; the campaign is the full
    cartesian product, optionally filtered by ``constraint`` (e.g. skip
    integer dtypes for MUFU-class ops).  ``quick_grid``, when given, is the
    reduced sweep used by ``--quick`` runs and CI smoke mode.
    """
    name: str
    description: str
    grid: Mapping[str, Sequence[Any]]
    runner: CellRunner
    quick_grid: Optional[Mapping[str, Sequence[Any]]] = None
    constraint: Optional[Callable[[Dict[str, Any]], bool]] = None
    backends: Tuple[str, ...] = ("cpu", "gpu", "tpu")
    cost_per_cell_s: float = 1.0
    tags: Tuple[str, ...] = field(default=())

    def axes(self, quick: bool = False) -> Mapping[str, Sequence[Any]]:
        if quick and self.quick_grid is not None:
            return self.quick_grid
        return self.grid

    def cells(self, quick: bool = False) -> list[Cell]:
        """Expand the (quick or full) grid into concrete cells, in a
        deterministic order, dropping constraint-violating combinations."""
        axes = self.axes(quick)
        names = list(axes)
        out = []
        for values in itertools.product(*(axes[n] for n in names)):
            params = dict(zip(names, values))
            if self.constraint is not None and not self.constraint(params):
                continue
            out.append(Cell(experiment=self.name, params=params))
        return out

    def estimated_cost_s(self, quick: bool = False) -> float:
        return self.cost_per_cell_s * len(self.cells(quick))

    def supports_backend(self, backend: str) -> bool:
        return backend in self.backends
