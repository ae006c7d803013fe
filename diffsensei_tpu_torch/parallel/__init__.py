"""Multi-GPU layouts along the data axis (port of ``diffsensei_tpu/parallel``):
process groups and the ``(data, model)`` device mesh (``mesh.py``), and the
data-parallel and FSDP training layer (``train.py``)."""
