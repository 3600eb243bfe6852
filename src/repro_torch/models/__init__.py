"""The port's language models (port of ``repro/models``): the decoder-only
transformer's serving path — prefill and one-token decode — for dense,
plain-GQA configs, with decode attention through the ``flash_decode``
kernel."""
