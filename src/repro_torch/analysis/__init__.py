"""repro_torch.analysis — roofline terms of a step (``roofline``)."""
