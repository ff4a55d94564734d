"""Hand-written CUDA kernels for Hopper (sm_90a) on the KG-creation path.

* ``hash_mix``     — fused 64-bit triple-key mixing (elementwise).
* ``bucket_dedup`` — radix-partitioned open-addressing dedup-insert: each
  partition's table slice lives in one CTA's shared memory for the whole
  probe/claim loop.
* ``nested_join``  — the naive engine's all-pairs equality join: one thread
  per child row, parent tiles streamed through shared memory.
* ``scan_join``    — the serving fast path's fused scan-join chain: one
  block per query (seeded split-key range searches, bind-join expansion,
  a bitonic sort over every output column).

Each kernel module holds the wrapper (kernel for a CUDA tensor, plain
PyTorch version for a CPU tensor) and a ``launches`` counter; ``ops.py``
holds the entry points, ``ref.py`` the oracles, ``_build.py`` the nvcc build and
ctypes binding of ``csrc/*.cu``.
"""
