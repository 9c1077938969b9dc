"""JASDA on PyTorch + CUDA: the port of ``repro`` to an NVIDIA H100.

The layout mirrors ``repro`` file for file.  The auction round
(``core``) runs its two hot spots -- batched Eq. 4 scoring with the FMP
safety check and the batched WIS settle -- through hand-written CUDA
kernels (``kernels``), with plain torch versions beside them.  Nothing here
imports JAX or the ``repro`` package; ``convert`` carries the reference's
state over by reading its fields.
"""
