"""host_ms.text_encoder: host milliseconds a call inside
``attngan.text_encoder`` (the BiLSTM and the word mask)."""

from perfbench.spans import TEXT_ENCODER, host_ms


def read(r):
    return host_ms(r, TEXT_ENCODER)
