"""Multi-rank execution on torch.distributed (port of occlusionfusion_tpu/parallel)."""
