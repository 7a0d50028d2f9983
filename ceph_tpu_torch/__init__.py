"""ceph_tpu_torch — the PyTorch + CUDA port of ``ceph_tpu``.

Batched CRUSH placement and RS erasure coding on an NVIDIA H100.  The
package keeps ``ceph_tpu``'s module names so each counterpart is easy
to find, imports ``torch`` and numpy only, and never imports ``jax`` or
any module of ``ceph_tpu``: what it needs from there it keeps as its
own copy.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
no card is present, unless the caller asked for ``device="cpu"``.  On a
CUDA tensor a kernel wrapper launches its hand-written kernel
(``csrc/``) or raises; on a CPU tensor it runs the kernel's plain
PyTorch version, which lives beside it.
"""
