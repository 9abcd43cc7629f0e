from repro_torch.kernels import dispatch, pairdist
