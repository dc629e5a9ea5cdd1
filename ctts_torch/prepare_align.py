"""Corpus normalization CLI of the port (prepare_align.py:7-25).

    python -m ctts_torch.prepare_align --dataset LJSpeech [--config_dir DIR]

Resamples the corpus at ``preprocess.path.corpus_path`` to the config's
rate, scales each wav to its peak and writes ``<speaker>/<id>.wav`` and the
cleaned ``<speaker>/<id>.lab`` under ``raw_path``, on the host
(``ctts_torch.preprocessing.ljspeech`` or ``vctk``).
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_dir", type=str, default=None)
    args = parser.parse_args(argv)
    from ctts_torch.config import get_configs_of
    config, _, _ = get_configs_of(args.dataset, args.config_dir)
    if args.dataset == "LJSpeech":
        from ctts_torch.preprocessing import ljspeech
        ljspeech.prepare_align(config)
    elif args.dataset == "VCTK":
        from ctts_torch.preprocessing import vctk
        vctk.prepare_align(config)
    else:
        raise ValueError(f"unknown dataset {args.dataset}")


if __name__ == "__main__":
    main()
