"""Plain NumPy reference that judges served plans (see ``check.py``)."""
