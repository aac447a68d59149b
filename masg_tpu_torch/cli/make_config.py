# Copied verbatim from masg_tpu/cli/make_config.py so the port imports nothing of the JAX package.
"""Generate reference-schema experiment config directories.

The reference ships 14 config families under config/ (SURVEY §2.10); this
generator produces equivalent dirs (preprocess.yaml + model.yaml + train.yaml
+ per-corpus preprocess_<CORPUS>.yaml) for any of the known presets, so users
don't have to hand-copy YAML. Existing reference config dirs also load
directly via core.config.load_config_dir.
"""

from __future__ import annotations

import argparse
import os

import yaml


def base_preprocess(metadata):
    return {
        "val_size": 0.2,
        "test_size": 0.2,
        "audio": {"sampling_rate": 22050, "max_wav_value": 32768.0},
        "stft": {"filter_length": 1024, "hop_length": 256, "win_length": 1024},
        "mel": {"n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000},
        "pitch": {"feature": "phoneme_level", "normalization": True},
        "energy": {"feature": "phoneme_level", "normalization": True},
        "speaker_generation": {"metadata": metadata},
    }


def base_model(use_jdit=False, gmm_mixtures=3):
    return {
        "transformer": {
            "encoder_layer": 4, "encoder_head": 2, "encoder_hidden": 256,
            "decoder_layer": 6, "decoder_head": 2, "decoder_hidden": 256,
            "conv_filter_size": 1024, "conv_kernel_size": [9, 1],
            "encoder_dropout": 0.2, "decoder_dropout": 0.2,
        },
        "variance_predictor": {"filter_size": 256, "kernel_size": 3, "dropout": 0.5},
        "variance_embedding": {
            "pitch_quantization": "linear", "energy_quantization": "linear",
            "n_bins": 256,
        },
        "jdit": {"use_jdit": use_jdit, "prenet_hidden": 256},
        "multi_speaker": True,
        "max_seq_len": 1000,
        "vocoder": {"model": "HiFi-GAN", "speaker": "universal"},
        "speaker_generation": {"GMM_mixtures": gmm_mixtures},
        "discriminator": {"hidden": 256},
    }


def base_train(name, total_step, lambd=None, discriminator_path=None, out_root="./output"):
    t = {
        "path": {
            "ckpt_path": f"{out_root}/ckpt/{name}",
            "log_path": f"{out_root}/log/{name}",
            "result_path": f"{out_root}/result/{name}",
        },
        "optimizer": {
            "batch_size": 16, "betas": [0.9, 0.98], "eps": 1e-9,
            "weight_decay": 0.0, "grad_clip_thresh": 1.0, "grad_acc_step": 1,
            "warm_up_step": 4000, "anneal_steps": [300000, 400000, 500000],
            "anneal_rate": 0.3,
        },
        "step": {"total_step": total_step, "log_step": 100, "synth_step": 1000,
                 "val_step": 1000, "save_step": 10000},
        "dataparallel": False,
    }
    if lambd is not None:
        t["lambda"] = lambd
    if discriminator_path is not None:
        t["path"]["discriminator_path"] = discriminator_path
    return t


def corpus_yaml(name, language, use_accent, data_root):
    return {
        "dataset": name,
        "path": {
            "corpus_path": f"{data_root}/{name}",
            "lexicon_path": "",
            "raw_path": f"./raw_data/{name}",
            "preprocessed_path": f"./preprocessed_data/{name}",
        },
        "text": {
            "text_cleaners": [] if language == "ja" else ["english_cleaners"],
            "language": language,
        },
        "accent": {"use_accent": use_accent},
    }


PRESETS = {
    # JSUT single-speaker Japanese, accents on (reference config/JSUT)
    "JSUT": dict(total_step=90000, corpora=[("JSUT", "ja", True)],
                 metadata={"gender": {"M": 0, "F": 1}}),
    # JVS multi-speaker Japanese
    "JVS": dict(total_step=30000, corpora=[("JVS", "ja", True)],
                metadata={"gender": {"M": 0, "F": 1}}),
    # JVS-VCTK bilingual pretrain
    "JVS-VCTK": dict(total_step=30000,
                     corpora=[("JVS", "ja", True), ("VCTK", "en", False)],
                     metadata={"gender": {"M": 0, "F": 1},
                               "language": {"ja": 0, "en": 1}}),
    # langemb fine-tune with adversarial discriminator (lambda sweep)
    "JVS-VCTK-langemb": dict(total_step=50000,
                             corpora=[("JVS", "ja", True), ("VCTK", "en", False)],
                             metadata={"gender": {"M": 0, "F": 1},
                                       "language": {"ja": 0, "en": 1}},
                             lambd=1.0),
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("preset", choices=sorted(PRESETS))
    parser.add_argument("-o", "--output", type=str, required=True,
                        help="config dir to create")
    parser.add_argument("--lambda", dest="lambd", type=float, default=None)
    parser.add_argument("--discriminator_path", type=str, default=None)
    parser.add_argument("--use_jdit", action="store_true")
    parser.add_argument("--data_root", type=str, default="/path/to/corpora")
    parser.add_argument("--total_step", type=int, default=None)
    args = parser.parse_args(argv)

    p = PRESETS[args.preset]
    os.makedirs(args.output, exist_ok=True)
    name = os.path.basename(os.path.normpath(args.output))

    def dump(fn, data):
        with open(os.path.join(args.output, fn), "w") as f:
            yaml.safe_dump(data, f, sort_keys=False)

    dump("preprocess.yaml", base_preprocess(p["metadata"]))
    dump("model.yaml", base_model(use_jdit=args.use_jdit))
    lambd = args.lambd if args.lambd is not None else p.get("lambd")
    dump("train.yaml", base_train(
        name, args.total_step or p["total_step"], lambd=lambd,
        discriminator_path=args.discriminator_path,
    ))
    for cname, lang, accent in p["corpora"]:
        dump(f"preprocess_{cname}.yaml", corpus_yaml(cname, lang, accent, args.data_root))
    print(f"wrote {args.preset} config -> {args.output}")


if __name__ == "__main__":
    main()
