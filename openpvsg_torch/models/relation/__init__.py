"""The relation head (stage 4 and 5's model), its losses and the host-side
pair and target helpers."""
