"""JASDA on PyTorch + CUDA: the port of ``repro`` to an NVIDIA H100.

The layout mirrors ``repro`` file for file.  The auction round
(``core``) runs its two hot spots -- batched Eq. 4 scoring with the FMP
safety check and the batched WIS settle -- through hand-written CUDA
kernels (``kernels``), with plain torch versions beside them.  LLM serving
(``models``, ``configs``, ``serving``, ``launch``) runs the mamba and
RG-LRU prefill scan through a third, and training under the JASDA
executor (``training``, ``data``, ``core.executor``, ``launch.train``)
runs it and its hand-written backward.  Nothing here imports JAX or the
``repro`` package; ``convert`` carries the reference's state, params and
optimizer state over by reading its fields.
"""
