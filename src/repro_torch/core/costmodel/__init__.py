"""The cost model of the port: the paper's measured tables, operational.

Three layers - instruction (per-op CPI, dependent/independent), memory
(hierarchy latencies + streaming bandwidth), MXU (the tensor cores' shape
and dtype throughput surface) - normalized from any calibration source
(``calibration``), composed by :class:`CostModel` (``model``) behind one
``predict(census, spec)`` API, with analytic censuses for steps the port
never lowers to a compiled module (``analytic``, which builds models to
count their parameters and is therefore imported on its own).

The reference's ``predict_compiled``/``predict_fn`` price HLO text, which
the port has none of: it prices analytic or JSON censuses only.

CLI: ``python -m repro_torch.core.costmodel --calibration hopper_h100
--prediction-error``.
"""
from repro_torch.core.costmodel.calibration import (  # noqa: F401
    CALIB_DIR, Calibration, InstructionEntry, MemoryLevel, MXUPoint,
    load_calibration)
from repro_torch.core.costmodel.instruction import (  # noqa: F401
    HLO_TO_TABLE, InstructionLayer, IssueCost)
from repro_torch.core.costmodel.memory import MemoryLayer  # noqa: F401
from repro_torch.core.costmodel.model import (  # noqa: F401
    CostModel, Prediction, prediction_error_rows, prediction_error_summary,
    save_calibration, validate_against_paper)
from repro_torch.core.costmodel.mxu import MXULayer  # noqa: F401
