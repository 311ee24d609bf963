"""Host utilities of the port: its logger, the region morphology of the
feature tables, the halo window tiling (``chunking``), the capacity path's
bit packing (``transfer``) and the same-device retry ladder
(``adaptive_run``)."""
