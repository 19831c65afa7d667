"""Plain PyTorch references, one a configuration (<config>.py), found by
the configuration's name. They import nothing of easyrec_torch."""
