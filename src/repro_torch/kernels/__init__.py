"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``paged_attention`` (wrapper ``kernels/paged_attention.py``, source
``csrc/paged_attention.cu``) is the decode attention of the paged serving
path; ``flash_attention`` (``kernels/flash_attention.py``,
``csrc/flash_attention.cu``) is the uncached forward attention of the slot
engine's prefill.  The paper's probes ``alu_chain``, ``pointer_chase`` and
``mxu_probe`` (``kernels/<name>.py``, ``csrc/<name>.cu``) are the kernels
of the measurement layer (``core/microbench``).  ``ops`` resolves their
launch configurations; ``ref`` holds the plain versions.
"""
