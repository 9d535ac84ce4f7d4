"""The plain reference: the published Mistral/Llama decoder in plain
PyTorch, float32 with TF32 off, over the benchmark's own seeded weights
and inputs. It imports nothing of the program."""
