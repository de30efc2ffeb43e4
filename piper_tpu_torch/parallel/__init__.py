"""Multi-slot serving: the (dp, sp, tp, pp) mesh, tensor and pipeline
parallelism, and ShardedVits (counterpart of piper_tpu.parallel)."""
