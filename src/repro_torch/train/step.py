"""The evaluation step, ported from ``repro.train.step.make_eval_step``.
Training (the optimizer, gradient accumulation, backward kernels) is
not ported yet."""
from __future__ import annotations

import torch


def make_eval_step(model):
    """``eval_step(params, batch) -> {'loss': 0-d tensor}``: the model's
    loss without gradients.  ``batch`` holds ``tokens`` and ``labels``
    [B,S], as numpy arrays or tensors; they are placed on the model's
    device (a no-op for tensors already there, so a caller that moved them
    beforehand keeps the step free of host copies)."""
    def eval_step(params, batch):
        batch = {k: torch.as_tensor(batch[k], device=model.device)
                 for k in ("tokens", "labels")}
        with torch.no_grad():
            loss, _ = model.loss(params, batch)
        return {"loss": loss}
    return eval_step
