"""Precision policy: residual-mode resolution and the escalation
ladder (policy.py)."""
