"""Multi-device execution over a (t, z) device grid.

Port of ``nellie_tpu/mesh``: frames (and files) spread over the mesh's
``t`` rows, each frame split over a row's ``z`` group with explicit halo
blocks, frame-wide statistics gathered on the group's first device and
connectivity joined across shards on the host, so that every result is
the single-device one, bit for bit.  The mesh lives in one process over
``torch.device``s; a device listed more than once is a logical shard.

Entry points: :func:`make_mesh`, :func:`shard_volume`,
:func:`sharded_segment_step`.
"""
from nellie_tpu_torch.mesh.sharded import (  # noqa: F401
    Mesh,
    make_hybrid_mesh,
    make_mesh,
    shard_volume,
    sharded_segment_step,
    sharded_vesselness,
)
