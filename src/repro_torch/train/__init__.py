"""The training step of the port, in PyTorch: `data` (the synthetic token
stream, the reference's numpy code), `loss` (cross-entropy in sequence
chunks), `optim` (AdamW with clipping and the LR schedule) and `step`
(`init_state`, `make_loss_fn`, `make_train_step`)."""
