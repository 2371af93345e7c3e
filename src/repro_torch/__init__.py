"""``repro_torch`` — the PyTorch/CUDA port of the TensorDash serving path.

It mirrors ``repro``'s layout module for module (``configs``, ``kernels``,
``runtime``, ``models``, ``serve``, ``launch``) so each module names the JAX
module it answers to.  It imports ``torch`` and nothing of JAX or ``repro``.

The planned block-sparse products run through two hand-written CUDA C++
kernels for Hopper (``kernels/csrc/tensordash_spmm.cu``), built with ``nvcc``
at first use.  Entry points run on the card (``device="cuda"``,
``backend="cuda"``) unless the caller asks for the CPU, where the ``dense``
and ``reference`` backends run the plain PyTorch executors.
"""
