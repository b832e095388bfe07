"""Data parallelism (``bts_tpu/parallel`` in PyTorch): one process a device
over ``torch.distributed`` (NCCL between cards, gloo on the CPU), with
``bts_tpu``'s global-batch semantics; the launcher; a replicated forward."""
