"""Encoders, the serving half of the PianoTree decoder, the latent-control
API and the fixed-batch Sampler."""
