"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, with ``--dry-run`` a trace of the
step instead), meshes over a ``torch.distributed`` world
(``launch/mesh.py``), the step builders and their shardings
(``launch/steps.py``), the closed-form step costs (``launch/analytic.py``)
and the dry run of every (arch x shape x mesh) cell on a fake world
(``python -m repro_torch.launch.dryrun``; its roofline readings in
``launch/roofline.py``, its optimization variants in
``python -m repro_torch.launch.perf``)."""
