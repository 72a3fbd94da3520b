"""svdss_tpu_torch — structural-variant discovery from sample-specific
strings, in PyTorch with hand-written CUDA kernels for one NVIDIA Hopper card.

The port of ``svdss_tpu`` (JAX), which stays beside it as the reference.
Same CLI stages (``index``, ``smooth``, ``search``, ``call``, ``run``), same
inputs and outputs. The device stages run on ``cuda`` unless the caller
asks for the CPU (``device="cpu"``, CLI ``--device cpu``), where each
kernel's plain PyTorch version runs instead; ``--no-device`` keeps the
exact host engines. Kernels live in ``csrc/`` and are built with ``nvcc``
at first use (``utils/device.py``).
"""

__version__ = "0.1.0"
