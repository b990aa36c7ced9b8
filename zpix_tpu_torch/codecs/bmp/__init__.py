"""zpix_tpu_torch.codecs.bmp: the port's copy of the BMP header parse, and a
numpy BMP writer."""
