"""Generation as a service on the GPU: `python -m dcgan_tpu_torch.serve`.

- `buckets.py`: the bucket ladder (the batch shapes the server dispatches);
- `sources.py`: `CheckpointSource`, the generator of a training
  checkpoint directory, and `WeightsSource`, the weights of a `.npz`;
- `server.py`: `SamplerServer`, queue + continuous batcher;
- `worker.py`: the dispatch thread that makes every CUDA call;
- `__main__.py`: the command-line entry point.
"""
