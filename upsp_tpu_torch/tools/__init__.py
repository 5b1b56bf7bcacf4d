"""Measurement programs of the port, each ``python -m
upsp_tpu_torch.tools.<name>`` with ``--device cuda`` (default) or ``cpu``:
``bench`` (1 MP frames/s), ``bench_fullconfig`` (the production
configuration, phase 1 and phase 2), ``profile_phase1`` (device time by
kernel), ``bench_ablate`` and ``bench_budget`` (the Gauss-Newton and
registration split), ``bench_endurance`` (out of core past device
memory), ``batch_stages`` (which stage depends on the frame batch),
``bench_components`` (device ms a frame of each phase-1 op) and
``bench_hbm`` (the device-memory rate of a pass); ``benchlib`` times
them.
"""
