"""The experiment drivers of the port: the model-configuration grid, the
loss comparison and the augmentation-amount sweep (the JAX package's
forward selection is not ported yet, ROADMAP A16)."""
