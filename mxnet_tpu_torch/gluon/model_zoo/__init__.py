"""Model zoo of the port: the Gluon BERT (``bert``) and the llama family
(``llama``, ``torch.nn`` modules so far)."""
