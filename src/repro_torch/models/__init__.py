"""The LM scaffold's models: layers, attention, Mamba-2 and assembly."""
