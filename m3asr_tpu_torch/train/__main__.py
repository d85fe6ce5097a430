"""``python -m m3asr_tpu_torch.train``: the port's training CLI
(:mod:`m3asr_tpu_torch.train.cli`)."""

from m3asr_tpu_torch.train.cli import main

main()
