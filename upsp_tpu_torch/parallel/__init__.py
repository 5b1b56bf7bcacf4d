"""Multi-device runs on ``torch.distributed``, one process per rank.

Port of ``upsp_tpu/parallel``: :mod:`.launcher` starts the process group
and plans each rank's video reads, :mod:`.mesh` holds the ranks and
their block ranges and the collectives (the frames->nodes exchange),
:mod:`.sharded_run` is phase 1 -> exchange -> phase 2 on in-memory
frames.
"""
