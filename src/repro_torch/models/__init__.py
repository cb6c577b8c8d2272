"""Model code: layers, attention, embedding, mixture of experts, the
decoder (``transformer``) and encoder-decoder (``encdec``) forwards."""
