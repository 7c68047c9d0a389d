"""The reference CLIs on the port: ``scripts/train`` (four train scripts)
and ``scripts/test`` (four evaluation scripts and the latency probe).  Each
module exposes ``build_parser()`` and ``main(args)`` and runs as
``python -m mimo_unet_torch.scripts.<train|test>.<name>`` or by its path."""
