"""Convert a reference biolip.pt (a torch pickle of complex records) to
the native numpy pickle (counterpart of scripts/convert_data.py). Every
CLI's --data_file reads both formats; the pickle loads without torch.

Example:
    python -m e3diff_tpu_torch.cli.convert_data --input biolip.pt \\
        --output data/biolip.pkl
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input", required=True, help="biolip.pt")
    p.add_argument("--output", required=True, help="output .pkl")
    args = p.parse_args(argv)

    from e3diff_tpu_torch.data.dataset import load_complexes, save_complexes

    data = load_complexes(args.input)
    save_complexes(data, args.output)
    print(f"converted {len(data)} complexes -> {args.output}")
    return data


if __name__ == "__main__":
    main()
