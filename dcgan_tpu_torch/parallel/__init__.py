"""Parallelism over processes (the counterpart of `dcgan_tpu/parallel`): one
process per GPU over torch.distributed (distributed.py), the (data, model)
mesh over the world's ranks (mesh.py), the cross-rank means, gathers,
point-to-point rings and all_to_alls (collectives.py), the height-sharded
step of the spatial mesh (spatial.py) and the per-rank training programs
(api.py: `make_parallel_train`). The ops import collectives.py, so this
package imports none of its modules itself."""
