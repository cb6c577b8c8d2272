"""Model code: layers, attention, embedding, the dense serving forward."""
