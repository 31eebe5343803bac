"""The paper's measurement primitives on the port: ALU chains (``harness``),
the pointer chase (``memory``), the tensor-core probe (``mxu``) and the
calibration tables they make (``tables``)."""
