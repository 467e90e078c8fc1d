"""Generation as a service on the GPU: `python -m dcgan_tpu_torch.serve`.

- `buckets.py`: the bucket ladder (the batch shapes the server dispatches);
- `sources.py`: `CheckpointSource`, the generator of a training
  checkpoint directory (with weight promotion, `reload()`),
  `WeightsSource`, the weights of a `.npz`, `StateSource`, a generator in
  memory, and `ArtifactSource`, an exported `.pt2` program;
- `quantize.py`: int8 quantize-dequantize of the served weights;
- `server.py`: `SamplerServer`, queue + continuous batcher + promotion
  control ops;
- `worker.py`: the dispatch thread that makes every CUDA call;
- `router.py`: the failover router over N replicas;
- `fleet.py`: `ServeFleet`, the replicas, the router and the promotion
  watcher;
- `__main__.py`: the command-line entry point.
"""
