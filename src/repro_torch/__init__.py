"""PyTorch/CUDA port of the ``repro`` TT + int4 serving stack.

The package mirrors ``repro``'s module layout (``config``, ``configs``,
``core``, ``kernels``, ``models``, ``serve``) so each counterpart sits at the
same path.  It imports ``torch``, ``numpy`` and the standard library only.

Entry points (``init_lm``, ``params_from_jax``, ``make_session``, ``Engine``)
run on the CUDA card unless the caller passes ``device="cpu"``; with no card
and no explicit CPU request they raise.  Kernels follow the tensor's device:
a CUDA tensor goes to the hand-written Hopper kernel, a CPU tensor to its
plain PyTorch version.
"""
from ._device import resolve_device  # noqa: F401
