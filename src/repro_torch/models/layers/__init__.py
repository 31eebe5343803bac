"""Layer functions of the port (``basic``, ``attention``)."""
