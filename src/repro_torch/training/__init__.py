"""Training substrate. So far only the data plane
(:mod:`repro_torch.training.data`: stream buckets -> token ids and LM
batches) is ported; the optimizer, steps and loop come with the training
slice."""
