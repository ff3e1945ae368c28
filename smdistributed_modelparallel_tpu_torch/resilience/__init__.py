"""Resilience of the PyTorch port: the elastic resume policy
(``elastic.py``). Preemption, chaos and the recovery supervisor arrive with
the operations slice."""
