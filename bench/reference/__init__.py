"""Plain PyTorch references of the served model families, in float32 with
TF32 off.  They import nothing of the program and take only the inputs the
benchmark made (weights, prompts) and the served tokens they judge."""
