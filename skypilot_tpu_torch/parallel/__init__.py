"""Parallelism (counterpart of ``skypilot_tpu/parallel/``): the process
groups and meshes (``mesh.py``), the Megatron and ZeRO-3 placement of
each parameter (``sharding.py``), the explicit collectives the model runs
where GSPMD would insert them (``collectives.py``) and the GPipe pipeline
(``pipeline.py``)."""
