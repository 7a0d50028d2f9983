"""The cluster services' host-side data types (the port's copy of
``ceph_tpu/services``, one module at a time)."""
