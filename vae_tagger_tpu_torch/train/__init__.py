"""Training of the port: ``python -m vae_tagger_tpu_torch.train.train_full``
(the VAE encoder and the tagger head end to end, simplified loss)."""
