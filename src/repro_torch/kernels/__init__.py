"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``paged_attention`` (wrapper ``kernels/paged_attention.py``, source
``csrc/paged_attention.cu``) is the decode attention of the paged serving
path; ``flash_attention`` (``kernels/flash_attention.py``) is the
uncached forward attention of the slot engine's prefill: bf16 with an f32
accumulator runs the tensor-core kernel ``csrc/flash_attention_mma.cu``,
f32 and the bf16 accumulator ``csrc/flash_attention.cu``.  ``wkv6`` and ``ssm_scan`` (``kernels/<name>.py``,
``csrc/<name>.cu``) are the recurrences of rwkv6's and hymba's train-mode
forward.  The paper's probes ``alu_chain``, ``pointer_chase`` and
``mxu_probe`` (``kernels/<name>.py``, ``csrc/<name>.cu``) are the kernels
of the measurement layer (``core/microbench``).  ``ops`` resolves their
launch configurations; ``ref`` holds the plain versions.
"""
