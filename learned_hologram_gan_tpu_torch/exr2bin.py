"""Convert folders of EXR files to raw float32 ``.bin`` datasets
(counterpart of the repo's ``exr2bin.py``).

Flag parity with the reference exr2bin.py: positional folders, then
``--channelsNum``, ``--height`` and ``--width``, with the same
missing-parameter messages and exit code 1.  Each folder's subfolders of
EXRs become ``<folder>/<subfolder>.bin`` (:func:`.data.exr.
read_exr_in_multi_folders`).  Host code; no device.

    python -m learned_hologram_gan_tpu_torch.exr2bin data/exr --channelsNum 3 \\
        --height 192 --width 192
"""

import argparse
import os
import sys

from .data.exr import read_exr_in_multi_folders


def process_folders(folders, channels_num, height, width):
    for folder in folders:
        if not os.path.exists(folder):
            print(f"Folder '{folder}' does not exist!")
        else:
            read_exr_in_multi_folders(folder, channels_num, height, width)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Process EXR files in multiple folders.")
    parser.add_argument("folders", metavar="F", type=str, nargs="+", help="The folders to process")
    parser.add_argument("--channelsNum", type=int, default=None, help="Number of channels (e.g., 3)")
    parser.add_argument("--height", type=int, default=None, help="Height of the images (e.g., 192)")
    parser.add_argument("--width", type=int, default=None, help="Width of the images (e.g., 192)")
    args = parser.parse_args(argv)
    for name in ("channelsNum", "height", "width"):
        if getattr(args, name) is None:
            print(f"Error: {name} parameter is missing.")
            return 1
    process_folders(args.folders, args.channelsNum, args.height, args.width)
    return 0


if __name__ == "__main__":
    sys.exit(main())
