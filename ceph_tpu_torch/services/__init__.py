"""The cluster services (the port's copy of ``ceph_tpu/services``): the
monitor and its quorum, the OSD daemon with its heartbeats and recovery,
the client with its striper and images, and the ``MiniCluster`` harness
that boots them on localhost sockets.  The EC data path runs on the
device each daemon is given."""
