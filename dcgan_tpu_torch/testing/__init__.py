"""Test support: deterministic fault injection (chaos.py).

Production code reaches it only through default-off hooks
(`chaos.active_plan()` is None unless a plan was selected), so the
injection points cost a None-check on the happy path.
"""
