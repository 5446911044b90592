"""The PyTorch serving engine: config, model, sampler, scheduler, facade."""
