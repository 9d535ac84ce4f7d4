"""Tensor parallelism for serving (counterpart of the ``tp`` half of
``skypilot_tpu/parallel/``): the process group (``mesh.py``), the
Megatron placement of each parameter (``sharding.py``) and the explicit
collectives the model runs where GSPMD would insert them
(``collectives.py``)."""
