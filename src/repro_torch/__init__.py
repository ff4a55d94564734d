"""repro_torch — the PyTorch/CUDA port of the SDM-RDFizer reproduction.

A second package beside the JAX one (``repro``), with the same layout so
each module's counterpart is easy to find.  It imports ``torch``, numpy
and the standard library only.  Device code runs on an NVIDIA Hopper card
by default: every entry point takes an explicit ``device`` that defaults to
``"cuda"``, and the CPU is used only when the caller asks for it.

The two kernels on the knowledge-graph creation path are written by hand
in CUDA C++ (``csrc/``): ``hash_mix`` (the 64-bit triple key) and
``bucket_dedup`` (the radix-partitioned PTT insert).  Each sits beside a
plain PyTorch version in the same module; a wrapper launches the kernel for
a CUDA tensor and runs the plain version for a CPU tensor.

uint32 words are stored as int32 bit patterns (``EMPTY`` is ``-1``, i.e.
``0xFFFFFFFF``); the plain versions do their arithmetic on int64 lanes
masked to 32 bits, and the CUDA kernels read the same buffers as
``uint32_t*``.
"""

__version__ = "0.1.0"
