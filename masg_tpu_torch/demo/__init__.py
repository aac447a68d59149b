"""One-command demos of the paper's recipe on the card (ports of masg_tpu's
scripts/demo_full_pipeline.py and scripts/demo_mid_attribute.py).

    python -m masg_tpu_torch.demo.full_pipeline --out DIR [--device cuda|cpu]
    python -m masg_tpu_torch.demo.mid_attribute --out DIR [--device cuda|cpu]

`stages` holds their steps, each a function that runs one part of the recipe
through the port's entry points and returns its evidence; `full_pipeline`
chains all of them and asserts masg_tpu's seven checks, `mid_attribute` the
corpus, FastSpeech2, vocoder, distribution and wav stages alone; `probe`
measures a finished full-pipeline run's vocoder and wavs where the F0 check
fails.
"""
