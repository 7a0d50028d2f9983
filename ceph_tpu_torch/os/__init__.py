"""Local object persistence — the port's copy of ``ceph_tpu/os``.

``ObjectStore``/``Transaction`` (src/os/ObjectStore.h,
src/os/Transaction.h): transactional collections of named objects with
byte extents, attrs and omap; ``MemStore`` in RAM, ``WALStore`` on disk,
``KeyValueDB`` over either.
"""
