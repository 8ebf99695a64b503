"""Plain float32 PyTorch models that decide ``correct``.

They follow the published descriptions (Mistral's and Mixtral's
``config.json`` and the Llama-style block they name) over the parameter
trees the harness makes, and import nothing of the program: no kernel, no
cache, no batching, TF32 off. Each departure from the published model is
noted where it is made.
"""
