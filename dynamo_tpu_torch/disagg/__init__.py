"""Disaggregated serving — the port holds only the failure taxonomy
(errors.py) so far; the KV transfer comes with the distributed runtime."""
