"""graftconc: the serve plane's concurrency lane.

The port of ``kaboodle_tpu/analysis/conc``: the static KB501-KB506 rules
(``rules.py``, gated on ``baseline.json`` by ``python -m
kaboodle_tpu_torch.analysis --conc``) and the runtime lock-order and
event-loop sanitizer (``sanitizer.py``, stdlib only).
"""
