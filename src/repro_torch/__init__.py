"""PyTorch/CUDA port of the MoE-Gen reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``repro_torch.models.moe`` <-> ``repro.models.moe`` and so on) and runs the
serving main path on an NVIDIA H100 with hand-written CUDA kernels for the
grouped expert FFN and decode attention (``repro_torch.kernels``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine without CUDA the default raises instead of running on the CPU.
"""
