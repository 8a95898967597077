"""Dataset converters of the port (raw dataset files -> info pickles)."""
