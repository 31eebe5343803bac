"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``paged_attention`` (wrapper ``kernels/paged_attention.py``, source
``csrc/paged_attention.cu``) is the one kernel of the paged serving path;
``ops`` resolves its launch configuration; ``ref`` holds the plain versions.
"""
