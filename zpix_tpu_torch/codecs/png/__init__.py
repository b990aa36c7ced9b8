"""zpix_tpu_torch.codecs.png: the port's copy of the PNG chunk layer."""
