"""The port's microbenchmark campaign runner: the registry of the paper's
four calibration experiments (``registry``), grid expansion (``spec``), the
resumable scheduler (``runner``), schema-versioned persistence
(``results``) and the campaign -> calibration-table bridge (``report``).

CLI: ``PYTHONPATH=src python -m repro_torch.core.campaign run <experiment>``
(on the card by default; ``--device cpu`` runs the plain versions).
"""
