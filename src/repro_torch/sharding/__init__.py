"""repro_torch.sharding — logical axes -> DTensor placements (``rules``)."""
