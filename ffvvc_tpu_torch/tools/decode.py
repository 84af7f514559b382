"""CLI decoder of the port: Annex-B .bit in, raw YUV out.

The same interface as `ffvvc_tpu.tools.decode`, with the port's device
options:

    python -m ffvvc_tpu_torch.tools.decode in.bit out.yuv [--md5]
        [--device cuda|cpu] [--device-pipeline] [--device-lmcs]
        [--device-deblock] [--device-sao] [--device-alf] [--device-mc]
        [--device-intra] [--no-native-cabac]

--device-pipeline runs the fused post-recon filter chain (LMCS, deblock,
SAO, ALF, CC-ALF) on --device.  --device-lmcs, --device-deblock,
--device-sao and --device-alf (ALF and CC-ALF) run that one stage on
--device, each with its own upload and download; they also take pictures
whose slices or tiles forbid filtering across their boundaries, which the
fused chain leaves to the host.  --device-mc runs the motion compensation
of inter frames on --device (ops/mc_device.py), --device-intra the intra
prediction and residual add of all-intra frames (ops/intra_device.py), each
alone or with any of the others.  Without any of them the decode runs on
the host.
"""
import argparse
import hashlib
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="ffvvc_tpu_torch VVC decoder")
    ap.add_argument("input", help="Annex-B VVC bitstream (.bit)")
    ap.add_argument("output", nargs="?", help="raw YUV output path")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the filter chain (cuda or cpu)")
    ap.add_argument("--device-pipeline", action="store_true",
                    help="run the fused post-recon filter chain on --device")
    for stage in ("lmcs", "deblock", "sao", "alf"):
        ap.add_argument(f"--device-{stage}", action="store_true",
                        help=f"run the {stage} stage on --device")
    ap.add_argument("--device-mc", action="store_true",
                    help="run inter motion compensation on --device")
    ap.add_argument("--device-intra", action="store_true",
                    help="run the intra recon of all-intra frames on "
                         "--device")
    ap.add_argument("--no-native-cabac", action="store_true")
    ap.add_argument("--md5", action="store_true",
                    help="print per-frame and stream MD5 (framemd5-style)")
    args = ap.parse_args(argv)

    from ffvvc_tpu_torch import DecoderConfig, VVCDecoder

    with open(args.input, "rb") as f:
        data = f.read()
    cfg = DecoderConfig(device=args.device,
                        device_pipeline=args.device_pipeline,
                        device_lmcs=args.device_lmcs,
                        device_deblock=args.device_deblock,
                        device_sao=args.device_sao,
                        device_alf=args.device_alf,
                        device_mc=args.device_mc,
                        device_intra=args.device_intra,
                        native_cabac=not args.no_native_cabac)
    t0 = time.monotonic()
    frames = VVCDecoder(cfg).decode(data)
    dt = time.monotonic() - t0

    out = open(args.output, "wb") if args.output else None
    stream_md5 = hashlib.md5()
    for i, fr in enumerate(frames):
        yuv = fr.to_yuv_bytes()
        stream_md5.update(yuv)
        if out:
            out.write(yuv)
        if args.md5:
            print(f"frame {i} poc {fr.poc} md5 "
                  f"{hashlib.md5(yuv).hexdigest()}")
    if out:
        out.close()
    if args.md5:
        print(f"stream md5 {stream_md5.hexdigest()}")
    print(f"{len(frames)} frames in {dt:.2f}s "
          f"({len(frames)/dt:.2f} fps)" if dt > 0 else f"{len(frames)} frames",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
