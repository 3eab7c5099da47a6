"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), meshes over a ``torch.distributed``
world (``launch/mesh.py``), the step builders and their shardings
(``launch/steps.py``) and the closed-form step costs
(``launch/analytic.py``, ``launch/dryrun.py``)."""
