"""Parallel execution helpers of the PyTorch port: activation checkpointing
and host offloading (``memory.py``), the ``recompute`` knob
(``remat_plan.py``), and pipeline parallelism: the schedule builders and the
1F1B executor (``pipeline_1f1b.py``), the partition and the stage executor
(``pipeline.py``), the cost-model partitioner (``module_partition.py``) and
its entry point (``partition.py``)."""
