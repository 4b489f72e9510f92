"""Undistort E2VID reconstruction PNGs for the e2v evaluation family.

Counterpart of upstream DEVO's scripts/e2v/undist_{eds,fpv,hku,mvsec,rpg,
tumvie,vector}.py (one script per benchmark there; one parameterized CLI
here). Per-benchmark calibrations come from devo_tpu_torch.data.calibs: built-in
published constants (EDS calib0/calib1, HKU/RPG per side) or the dataset's
shipped calibration files (--calib-file for MVSEC camchain / TUM-VIE JSON /
FPV camchain / VECtor yaml); a manual --calib override is always accepted.
Output goes to <indir>/../e2calib_undistorted with the reference's 21-digit
frame naming.

The port's own copy of scripts/e2v_undist.py, on devo_tpu_torch's modules: the
same arguments and outputs.
"""
from __future__ import annotations

import argparse
import glob
import os.path as osp

from devo_tpu_torch.data import calibs


def undistort_dir(indir: str, cam, H: int = None, W: int = None):
    from devo_tpu_torch.data.preprocess import new_camera_matrix, undistort_images

    # the calibration's own resolution wins; --res is only a fallback for
    # size-less manual overrides (the reference asserts the image matches
    # the calibration's size)
    if cam.size != (0, 0):
        H, W = cam.size
    if not H or not W:
        raise SystemExit("no resolution: calibration has no size and no "
                         "--res given")
    K_new = new_camera_matrix(cam.K, cam.dist_np, H, W, cam.model, cam.policy)
    outdir = osp.join(osp.dirname(indir.rstrip("/")), "e2calib_undistorted")
    assert osp.abspath(outdir) != osp.abspath(indir)
    files = sorted(glob.glob(osp.join(indir, "*.png")))
    n = undistort_images(files, outdir, cam.K, cam.dist_np, K_new, H, W,
                         cam.model, name_fmt="{i:021d}.png")
    print(f"undistorted {n} images -> {outdir} "
          f"(K_new fx={K_new[0, 0]:.2f} cx={K_new[0, 2]:.2f})")
    return outdir, K_new


def resolve_calib(a) -> "calibs.CamCalib":
    if a.calib:  # manual override: "fx fy cx cy k1 k2 ..." or a json file
        if a.calib.endswith(".json"):
            return calibs.from_user_json(a.calib)
        v = [float(x) for x in a.calib.replace(",", " ").split()]
        size = tuple(a.res) if a.res[0] and a.res[1] else (0, 0)
        return calibs.CamCalib(v[0], v[1], v[2], v[3], tuple(v[4:]),
                               size=size)
    b = a.benchmark
    if b == "eds":
        return calibs.EDS[(a.calibstr, "evs")]
    if b == "hku":
        return calibs.HKU[a.side]
    if b == "rpg":
        return calibs.RPG_180x240[a.side]
    if not a.calib_file:
        raise SystemExit(f"{b}: pass --calib-file (dataset calibration) "
                         "or --calib")
    if b == "mvsec":
        return calibs.read_mvsec_camchain(a.calib_file, a.side)
    if b == "tumvie":
        # E2VID reconstructions live on the event camera's pixel grid, but
        # the reference undistorts them with the balance=0 pinhole target
        # (scripts/e2v/undist_tumvie.py) — for_images picks that policy
        return calibs.read_tumvie_calib(a.calib_file,
                                        2 if a.side == "left" else 3,
                                        for_images=True)
    if b == "fpv":
        return calibs.read_fpv_calib(a.calib_file)
    if b == "vector":
        return calibs.read_vector_calib(a.calib_file)
    raise SystemExit(f"unknown benchmark {b}")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="undistort e2vid reconstructions")
    p.add_argument("--indir", required=True, help="dir of e2vid/e2calib PNGs")
    p.add_argument("--benchmark", default="eds",
                   choices=["eds", "fpv", "hku", "mvsec", "rpg", "tumvie",
                            "vector"])
    p.add_argument("--calibstr", default="calib0",
                   help="EDS calibration set (calib0/calib1)")
    p.add_argument("--side", default="left", choices=["left", "right"])
    p.add_argument("--calib-file", default=None,
                   help="dataset-shipped calibration file (camchain yaml / "
                        "TUM-VIE json / VECtor yaml)")
    p.add_argument("--calib", default=None,
                   help='manual override: "fx fy cx cy k1 k2 ..." or json')
    p.add_argument("--res", type=int, nargs=2, default=(None, None),
                   help="H W fallback when the calibration has no size")
    a = p.parse_args()
    assert "e2vid" in a.indir or "e2calib" in a.indir
    undistort_dir(a.indir, resolve_calib(a), a.res[0], a.res[1])
