"""nn.Module models with the reference checkpoints' state_dict keys."""
