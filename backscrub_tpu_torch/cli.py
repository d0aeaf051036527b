"""backscrub-compatible CLI on the PyTorch port (counterpart of
``backscrub_tpu/cli.py``; installed as ``backscrub-torch``).

Flag-compatible with the reference app (usage text at
app/deepseg.cc:505-530): -? -d -s -c -v -w -h --cg --vg -f -t -b -m
-p bgblur:<n> -H -V, same defaults (-c /dev/video0, -v /dev/video1,
640x480, MLKit selfie model, app/deepseg.cc:362-376), same /dev/ prefix
auto-add (:536-539), and the JAX CLI's additions for headless use, every
one of them served: ``--bf16`` runs the CNN in bfloat16 with one-pass bf16
dots (``compute_dtype=torch.bfloat16, precision="default"``), ``--int8``
loads per-channel int8 kernels (the classic stages).  The frame pipeline
runs on the CUDA card (``main(argv, device="cuda")``); without one
``main`` prints an error and returns 1.

Run it as ``python -m backscrub_tpu_torch.cli -c test: -v file:/tmp/o.yuv
-m tests/data/selfie_synth_mlkit_256x256.tflite --frames 60``.
"""

from __future__ import annotations

import json
import signal
import sys
from typing import List, Optional

import numpy as np

from .models.specs import DEFAULT_MODEL


def parse_geometry(s: str):
    try:
        w, h = s.lower().split("x")
        return int(w), int(h)
    except ValueError:
        return None


USAGE = """\
usage:
  backscrub [-?] [-d] [-s] [-c <capture>] [-v <virtual>] [--cg <width>x<height>]
    [--vg <width>x<height>] [-t <threads>] [-b <background>] [-m <model>] [-p <option:value>]

-?            Display this usage information
-d            Increase debug level
-s            Show progress bar
-c            Video capture source: /dev/videoN, file:<path>, image, test:,
              or mjpg: (synthetic MJPG camera; decoded on the card)
-v            Virtual camera sink: /dev/videoN, file:<path.mp4|.yuv>, or null:
-w            DEPRECATED: Specify the video stream width
-h            DEPRECATED: Specify the video stream height
--cg          Capture device geometry as <width>x<height>
--vg          Virtual camera geometry as <width>x<height>
-f            Camera video format, i.e. YUYV or 56595559
-t            Threads (accepted for compatibility; the card runs the compute)
-b            Background (any local or network OpenCV source)
-m            Segmentation model (.tflite)
-p            Add post-processing steps
-p bgblur:<strength>   Blur the video background
-p bgpixelate:<n>      Mosaic the background with n x n tiles (privacy mode)
-p bgdesat             Desaturate (grayscale) the background
-p refine:guided       Edge-aware mask refinement (guided filter on the frame)
-p morph:<op>[:k]      Mask morphology: erode|dilate|open|close, odd k (default 3)
-p jpegq:<1-100>       JPEG quality for --sink-format mjpg (default 85)
-H            Mirror the output horizontally
-V            Mirror the output vertically
--frames N    Process N frames then exit (0 = run forever)
--bf16        Run the CNN in bfloat16, its dots one bf16 pass
--int8        Quantize conv kernels to per-channel int8 (the classic stages)
--no-bilateral  Skip the bilateral prefilter
--correct-colors  Use spec-correct YUYV (the reference feeds BGR to RGB2YUV)
--staging     Upload frames through page-locked host buffers (byte-identical
              output). A startup probe measures staged vs plain roundtrips
              at the capture geometry and keeps the winner
--staging-force  Staging without the probe (trust the flag)
--sink-format yuyv|nv12|i420|bgr24|mjpg   Virtual-camera pixel format
              (default yuyv; 4:2:0 formats are packed on the card, BT.601,
              cv2-bit-exact; mjpg encodes on the card, the host only
              Huffman-packs, bytes as cv2.imencode)
--stats-json <path>  Append a JSON stats line (fps + per-stage ms) every
              120 frames and at exit, for production monitoring
--drain-thread  Deliver results to the sink from a dedicated thread so
              device->host downloads overlap the next frame's upload/dispatch
"""


def parse_args(argv: List[str]) -> Optional[dict]:
    cfg = dict(debug=0, progress=False, ccam="/dev/video0", vcam="/dev/video1",
               cap_geo=None, vid_geo=None, fourcc="", threads=2,
               background=None, model=DEFAULT_MODEL,
               blur_strength=0, mask_refine="box", flip_h=False, flip_v=False,
               width=640, height=480, set_w_or_h=False,
               frames=0, bf16=False, int8=False, bilateral=True,
               correct_colors=False, staging=False, staging_force=False,
               sink_format="yuyv",
               stats_json=None, drain_thread=False, jpeg_quality=85,
               bg_pixelate=0, bg_desaturate=False, mask_morph="")
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            if i >= len(argv):
                raise ValueError(f"missing value for {a}")
            return argv[i]

        if a == "-?":
            return None
        elif a == "-d":
            cfg["debug"] += 1
        elif a == "-s":
            cfg["progress"] = True
        elif a == "-H":
            cfg["flip_h"] = True
        elif a == "-V":
            cfg["flip_v"] = True
        elif a == "-c":
            cfg["ccam"] = val()
        elif a == "-v":
            cfg["vcam"] = val()
        elif a == "-w":
            cfg["width"] = int(val()); cfg["set_w_or_h"] = True
        elif a == "-h":
            cfg["height"] = int(val()); cfg["set_w_or_h"] = True
        elif a in ("--cg", "--vg"):
            geo = parse_geometry(val())
            if geo is None:
                raise ValueError(f"{a} expects <width>x<height>")
            cfg["cap_geo" if a == "--cg" else "vid_geo"] = geo
        elif a == "-f":
            cfg["fourcc"] = val()
        elif a == "-t":
            cfg["threads"] = int(val())
        elif a == "-b":
            cfg["background"] = val()
        elif a == "-m":
            cfg["model"] = val()
        elif a == "-p":
            opt = val()
            if opt.startswith("bgblur"):
                # reference behavior (app/deepseg.cc:420-430): odd required,
                # non-numeric value falls back to default strength 25
                value = opt.split(":", 1)[1] if ":" in opt else ""
                if value.isdigit():
                    n = int(value)
                    if n % 2 == 0:
                        raise ValueError("strength value must be odd")
                    cfg["blur_strength"] = n
                else:
                    print("No strength value supplied, using default strength 25",
                          file=sys.stderr)
                    cfg["blur_strength"] = 25
            elif opt.startswith("refine"):
                mode = opt.split(":", 1)[1] if ":" in opt else "guided"
                if mode not in ("box", "guided"):
                    raise ValueError(f"refine mode must be box|guided, got {mode!r}")
                cfg["mask_refine"] = mode
            elif opt.startswith("jpegq"):
                value = opt.split(":", 1)[1] if ":" in opt else "85"
                if not value.isdigit() or not 1 <= int(value) <= 100:
                    raise ValueError("jpegq value must be 1..100")
                cfg["jpeg_quality"] = int(value)
            elif opt.startswith("bgpixelate"):
                value = opt.split(":", 1)[1] if ":" in opt else "16"
                if not value.isdigit() or int(value) < 2:
                    raise ValueError("bgpixelate tile size must be >= 2")
                cfg["bg_pixelate"] = int(value)
            elif opt == "bgdesat":
                cfg["bg_desaturate"] = True
            elif opt.startswith("morph"):
                spec = opt.split(":", 1)[1] if ":" in opt else "open"
                parts = spec.split(":")
                if parts[0] not in ("erode", "dilate", "open", "close"):
                    raise ValueError("morph op must be erode|dilate|open|close")
                if len(parts) > 1 and (not parts[1].isdigit()
                                       or int(parts[1]) % 2 == 0):
                    raise ValueError("morph kernel must be an odd integer")
                cfg["mask_morph"] = spec
            else:
                raise ValueError(f"unknown post-processing option {opt!r}")
        elif a == "--frames":
            cfg["frames"] = int(val())
        elif a == "--bf16":
            cfg["bf16"] = True
        elif a == "--int8":
            cfg["int8"] = True
        elif a == "--no-bilateral":
            cfg["bilateral"] = False
        elif a == "--correct-colors":
            cfg["correct_colors"] = True
        elif a == "--staging":
            cfg["staging"] = True
        elif a == "--staging-force":
            cfg["staging"] = True
            cfg["staging_force"] = True
        elif a == "--sink-format":
            fmt = val().lower()
            if fmt not in ("yuyv", "nv12", "i420", "bgr24", "mjpg"):
                raise ValueError(
                    f"--sink-format must be yuyv|nv12|i420|bgr24|mjpg, got {fmt!r}")
            cfg["sink_format"] = fmt
        elif a == "--stats-json":
            cfg["stats_json"] = val()
        elif a == "--drain-thread":
            cfg["drain_thread"] = True
        else:
            raise ValueError(f"unknown argument {a!r}")
        i += 1

    # deprecated -w/-h vs --cg/--vg interlock (app/deepseg.cc:495-499)
    if cfg["set_w_or_h"] and (cfg["cap_geo"] or cfg["vid_geo"]):
        raise ValueError("(DEPRECATED) -w/-h used in conjunction with --cg/--vg")
    if cfg["cap_geo"] is None:
        cfg["cap_geo"] = (cfg["width"], cfg["height"])
    # permit unprefixed device names (app/deepseg.cc:536-539)
    for key in ("ccam", "vcam"):
        v = cfg[key]
        if not any(v.startswith(p) for p in ("/dev/", "file:", "test:", "mjpg:", "null:",
                                             "http://", "https://")) \
                and not ("." in v or "/" in v):
            cfg[key] = "/dev/" + v
    return cfg


def main(argv: Optional[List[str]] = None, *, device="cuda") -> int:
    """Run the CLI; ``device`` is the torch device the pipeline runs on
    (tests pass "cpu")."""
    argv = sys.argv[1:] if argv is None else argv
    try:
        cfg = parse_args(argv)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        print(USAGE, file=sys.stderr)
        return 1
    if cfg is None:
        print(USAGE, file=sys.stderr)
        return 1

    import torch
    from . import _build
    try:
        dev = _build.resolve_device(device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    from .io.background import load_background
    from .io.streams import open_sink, open_source
    from .models.specs import resolve_model_path, resolve_path
    from .pipeline.frame import FramePipeline, PipelineConfig
    from .pipeline.maskgen import bs_tensorflow_version
    from .utils.timing import StageTimer

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backscrub-torch (PyTorch runtime {bs_tensorflow_version()}, "
          f"device {dev} {name})", file=sys.stderr)

    cw, ch = cfg["cap_geo"]
    try:
        source = open_source(cfg["ccam"], cw, ch, cfg["fourcc"])
    except OSError as e:
        print(f"Error: cannot open capture source {cfg['ccam']}: {e}",
              file=sys.stderr)
        return 1
    # adopt granted geometry, warning like the reference (deepseg.cc:554-561)
    if (source.width, source.height) != (cw, ch):
        print("Warning: capture device geometry changed from requested values.",
              file=sys.stderr)
    cw, ch = source.width, source.height
    vw, vh = cfg["vid_geo"] or (cw, ch)
    # aspect-ratio mismatch warning (deepseg.cc:567-571; integer math to
    # avoid comparing doubles, same trick)
    if vh * cw // ch != vw:
        print("Warning: virtual camera aspect ratio does not match capture "
              "device.", file=sys.stderr)

    try:
        model_path = resolve_model_path(cfg["model"])
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        source.close()
        return 1
    # native YUYV/UYVY/NV12 cameras upload raw bytes and the card decodes
    # them (less host->device traffic, no host cvtColor on the critical
    # path); MJPG cameras upload entropy-decoded coefficients and the card
    # runs the rest of the decode (bs_jpeg_decode)
    raw_fmt = getattr(source, "raw_format", None)
    raw_ingest = raw_fmt in ("yuyv", "uyvy", "nv12")
    jpeg_info = getattr(source, "jpeg_info", None)
    in_fmt = "mjpg" if jpeg_info is not None else raw_fmt if raw_ingest else "bgr"
    pcfg = PipelineConfig(
        width=cw, height=ch, out_width=vw, out_height=vh,
        blur_strength=cfg["blur_strength"],
        bg_pixelate=cfg["bg_pixelate"], bg_desaturate=cfg["bg_desaturate"],
        flip_horizontal=cfg["flip_h"], flip_vertical=cfg["flip_v"],
        use_bilateral=cfg["bilateral"], correct_colors=cfg["correct_colors"],
        mask_refine=cfg["mask_refine"], mask_morph=cfg["mask_morph"],
        input_format=in_fmt, jpeg_info=jpeg_info,
        output_format="bgr" if cfg["sink_format"] == "bgr24" else cfg["sink_format"],
        out_jpeg_quality=cfg["jpeg_quality"],
    )
    try:
        pipe = FramePipeline(model_path, pcfg, device=dev,
                             compute_dtype=torch.bfloat16 if cfg["bf16"] else torch.float32,
                             precision="default" if cfg["bf16"] else None,
                             quantize="int8" if cfg["int8"] else None)
    except Exception:
        source.close()
        raise

    if cfg["debug"]:
        print(f"model: {model_path}\ncapture: {cfg['ccam']} {cw}x{ch}\n"
              f"output: {cfg['vcam']} {vw}x{vh}\n"
              f"background: {cfg['background']}", file=sys.stderr)

    # background resolves through the 5-step search with type "backgrounds"
    # (deepseg.cc:541); resolution or load failure -> green fallback
    # (deepseg.cc:596-603)
    bg_path = resolve_path(cfg["background"], "backgrounds") \
        if cfg["background"] else None
    background = load_background(bg_path, cfg["debug"]) if bg_path else None
    if cfg["background"] and background is None:
        print("Warning: could not load background image, defaulting to green",
              file=sys.stderr)

    sink = open_sink(cfg["vcam"], vw, vh, out_format=cfg["sink_format"],
                     jpeg_info=pipe.out_jpeg_info, jpeg_qtabs=pipe.out_jpeg_qtabs)
    timer = StageTimer()

    # debug window + runtime toggles (app/deepseg.cc:724-803)
    from .utils.debug_ui import DebugState, DebugWindow, compose_debug_view
    state = DebugState(flip_horizontal=cfg["flip_h"], flip_vertical=cfg["flip_v"])
    window = DebugWindow() if cfg["debug"] >= 2 else None
    if window is not None and not window.available:
        print("debug: no display available, HUD disabled", file=sys.stderr)
    if window is not None and cfg["sink_format"] == "mjpg":
        print("debug: HUD preview not supported with --sink-format mjpg, "
              "HUD disabled", file=sys.stderr)
        window = None

    from .runtime.serving import ServingLoop
    use_staging = cfg["staging"]
    if use_staging and not cfg["staging_force"]:
        # measure, don't assume: keep staging only where the probe at this
        # capture geometry shows it faster (--staging-force skips it)
        from .io.staging import probe_staging
        pw, ph = pipe.cfg.width, pipe.cfg.height
        pr = probe_staging(pw, ph, device=dev)
        if not pr["supported"]:
            print("staging: pinned_host memory not available on this "
                  "backend, using plain transfers", file=sys.stderr)
            use_staging = False
        elif not pr["use_staging"]:
            print(f"staging: DISABLED by startup probe — staged roundtrip "
                  f"{pr['staged_ms']:.3f} ms/frame vs plain "
                  f"{pr['plain_ms']:.3f} ms at {pw}x{ph}"
                  " (pass --staging-force to override)", file=sys.stderr)
            use_staging = False
        else:
            print(f"staging: enabled (probe: staged {pr['staged_ms']:.3f} ms"
                  f"/frame vs plain {pr['plain_ms']:.3f} ms)", file=sys.stderr)
    loop = ServingLoop(pipe, depth=3, staging=use_staging,
                       drain_thread=cfg["drain_thread"])
    if use_staging and not loop.staging.supported:
        print("staging: pinned_host memory not available on this backend, "
              "using plain transfers", file=sys.stderr)

    # graceful SIGTERM (service managers send it on stop): drain the ring
    # and close devices cleanly instead of dying mid-write; the previous
    # handler comes back when main returns
    def _sigterm(_sig, _frm):
        state.running = False
    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        prev_sigterm = None  # not the main thread (embedded use)

    stats_f = open(cfg["stats_json"], "a") if cfg["stats_json"] else None

    def emit_stats(final=False):
        if stats_f is None:
            return
        rec = timer.report_dict()
        rec["frames"] = n
        if final:
            rec["final"] = True
        stats_f.write(json.dumps(rec) + "\n")
        stats_f.flush()

    n = 0
    try:
        while state.running and (cfg["frames"] == 0 or n < cfg["frames"]):
            timer.start()
            frame = source.read_raw() if raw_ingest else source.read()
            if frame is None:
                break
            timer.mark("grab")
            bg = background.grab(cw, ch) if background else None
            toggles = dict(flip_horizontal=state.flip_horizontal,
                           flip_vertical=state.flip_vertical,
                           filter_active=state.filter_active)
            if window is not None and window.available:
                # HUD mode: synchronous step so the mask/output pair shown
                # is the frame just processed (debug, not perf-critical)
                out, mask = pipe.step(frame, bg, **toggles)
                out_np = out.cpu().numpy()  # sync: dispatch covers device time
                timer.mark("dispatch")
                sink.write_yuyv(out_np)
                timer.mark("sink")
                from .io.streams import packed_to_bgr
                test = packed_to_bgr(out_np, cfg["sink_format"], vw, vh)
                # decoupled telemetry like the reference's dual FPS
                # (deepseg.cc:702-719): main = loop rate, AI = model-step rate
                view = compose_debug_view(
                    test, state, mask=mask.cpu().numpy(),
                    bg_thumb=background.thumbnail() if background else None,
                    main_fps=timer.fps, ai_fps=timer.stage_fps("dispatch"),
                    cap_geo=(cw, ch), vid_geo=(vw, vh))
                window.show(view, state)
            else:
                loop.submit(frame, bg, **toggles)
                timer.mark("dispatch")
                if loop.drain_ready(sink.write_yuyv):
                    timer.mark("sink")
            n += 1
            timer.frame_done()
            if cfg["progress"]:
                print(".", end="", flush=True)
            if n % 120 == 0:
                if cfg["debug"]:
                    print(timer.report_line(), file=sys.stderr)
                emit_stats()
    except KeyboardInterrupt:
        pass
    finally:
        try:
            loop.drain_all(sink.write_yuyv)
        finally:
            loop.close()
            source.close()
            sink.close()
            if background:
                background.close()
            if window is not None:
                window.close()
            emit_stats(final=True)
            if stats_f is not None:
                stats_f.close()
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
    if cfg["progress"]:
        print()
    print(f"processed {n} frames ({timer.fps:.1f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
