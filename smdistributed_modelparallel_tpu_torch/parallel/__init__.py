"""Parallel execution helpers of the PyTorch port: activation checkpointing
and host offloading (``memory.py``) and the ``recompute`` knob
(``remat_plan.py``). The pipeline executors and their recompute planner
arrive with the pipeline slice."""
