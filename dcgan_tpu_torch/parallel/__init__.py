"""Data parallelism over processes (the counterpart of `dcgan_tpu/parallel`):
one process per GPU over torch.distributed (distributed.py), the mesh over
the world's ranks (mesh.py), the cross-rank means and gathers
(collectives.py) and the per-rank training programs (api.py:
`make_parallel_train`). The ops import collectives.py, so this package
imports none of its modules itself."""
