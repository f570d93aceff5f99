"""repro_torch -- the PyTorch + CUDA port of ``repro``.

It mirrors ``repro`` subpackage for subpackage (``core``, ``memory``,
``kernels``, ``flow``, ``cfd``, the serving stack ``serve``, ``trace``,
``metrics`` and ``runtime.monitor``, and for the decoder LMs ``models``,
``configs``, ``runtime``) and imports neither JAX nor ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Plans and reports keep the reference's backend strings:
``pallas`` means the hand-written CUDA kernel (``kernels``, sources in
``csrc``), ``xla`` the plain whole-program PyTorch path.
"""
