"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``paged_attention`` (wrapper ``kernels/paged_attention.py``, source
``csrc/paged_attention.cu``) is the decode attention of the paged serving
path; ``flash_attention`` (``kernels/flash_attention.py``) is the
uncached forward attention of the slot engine's prefill: bf16 with an f32
accumulator runs the tensor-core kernel ``csrc/flash_attention_mma.cu``,
f32 and the bf16 accumulator ``csrc/flash_attention.cu``; its gradient
(``FlashAttentionFn``, the dense family's training) follows the same
rule: the tensor-core backward ``csrc/flash_attention_bwd_mma.cu`` where
the forward ran on the tensor cores, else the CUDA-core
``csrc/flash_attention_bwd.cu``.  ``wkv6`` and ``ssm_scan`` (``kernels/<name>.py``,
``csrc/<name>.cu``) are the recurrences of rwkv6's and hymba's train-mode
forward; their gradients (``Wkv6Fn``, ``SsmScanFn``: rwkv6's and hymba's
training) are ``csrc/wkv6_bwd.cu`` and ``csrc/ssm_scan_bwd.cu``.  The
paper's probes ``alu_chain``, ``pointer_chase`` and ``mxu_probe``
(``kernels/<name>.py``, ``csrc/<name>.cu``) are the kernels of the
measurement layer (``core/microbench``).  ``ops`` resolves their launch
configurations; ``ref`` holds the plain versions.  ``paged_attention``,
the one kernel on a differentiable path without a backward, refuses
inputs that require grad (``refuse_grad``).
"""


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError``, naming ``kernel``, when grad mode is
    on and one of ``tensors`` requires grad: a kernel with no backward
    must never drop a gradient silently, on the card or on the CPU."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward: its CUDA kernel is invisible to "
            "autograd, so a gradient through it would stop silently (run it "
            "under torch.no_grad(), or with inputs that need no grad)")
