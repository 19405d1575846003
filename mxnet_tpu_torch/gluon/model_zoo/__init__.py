"""Model zoo of the port: the llama family so far."""
