"""zpix_tpu_torch.codecs.qoi: the port's copy of the host QOI codec."""
