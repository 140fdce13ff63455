"""Convert an EMAN2 ``bdb:`` particle container to an EMAN2-HDF stack,
with the PyTorch/CUDA port's modules (``cryo_ralib_tpu_torch.io``): the
container is read through the system's libdb and the HDF5 file written by
the port's own writer, so neither EMAN2 nor h5py is needed.  The port's
command line also reads ``bdb:`` inputs directly; this gives a portable
copy (EMAN2's ``e2proc2d.py bdb:... stack.hdf``).

Usage:
    python tools/torch_bdb_to_hdf.py bdb:particles#stack out.hdf
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2 or not argv[0].startswith("bdb:"):
        print(__doc__, file=sys.stderr)
        return 2
    src, dst = argv

    from cryo_ralib_tpu_torch.io.bdb import read_bdb_stack
    from cryo_ralib_tpu_torch.io.eman_hdf import write_hdf_stack

    images, headers = read_bdb_stack(src)
    # strip the bdb-internal data pointers; keep the science attributes
    clean = [{k: v for k, v in h.items()
              if k not in ("data_path", "data_n")} for h in headers]
    write_hdf_stack(dst, images, headers=clean)
    print(f"wrote {images.shape[0]} images ({images.shape[2]}x"
          f"{images.shape[1]}) to {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
