"""The tools of ``tools/`` for the card.  The TPU probes redone as CUDA
kernels with plain versions: ``unaligned_probe`` (window copies from
aligned and odd starts) and ``span_dma_probe`` (one staged window against
several spans per query block), with ``launch_probe`` (host microseconds a
launch) and ``forces_probe`` (the forces kernel against other builds of
itself: bitwise outputs, time a launch, registers and resident blocks).  The questions of the physics and of the card, each a
``main(argv) -> dict`` with ``--device`` (cuda by default, no CPU
fallback): ``frames_to_gif`` (a FileSink capture to a GIF),
``render_probe`` (frame reuse against the self-sorting render),
``dd_probe`` (one slab's sticky groups against its exact steps),
``dynamic_stale_probe`` (the drift guard on the dam's collapse surge) and
``cfl_probe`` (max speed against the dt factor).  ``multihost_worker`` runs
the decomposition over processes.  Each module runs as a script."""
