"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), the step builders
(``launch/steps.py``) and the closed-form step costs
(``launch/analytic.py``, ``launch/dryrun.py``)."""
