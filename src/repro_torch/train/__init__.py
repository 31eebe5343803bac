"""Steps over a model of the port: evaluation (``step.make_eval_step``)."""
