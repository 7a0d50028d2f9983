"""Cluster fabric — the reference's src/msg surface (the port's copy
of ``ceph_tpu/msg``).

``messenger.Messenger`` is a threaded TCP transport with
length-prefixed frames (a JSON control segment and raw data segments),
typed dispatch and reconnecting, replaying sessions — the
Messenger/Dispatcher seam (src/msg/Messenger.h, Dispatcher.h).  Its
frames are byte-for-byte ``ceph_tpu``'s, so messengers of the two
packages talk to each other.  It holds no device code: a handler that
hands a received object to the card (the EC engine's
``encode_prepare``) does so itself, and a tensor inside a message is
refused, never converted.
"""
