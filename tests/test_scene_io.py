import json

import numpy as np
import pytest

from tpu_pathtracer.scene import (
    load_scene_desc, materials_to_arrays, MAT_FRESNEL, MAT_GLASS, MAT_REFL,
    MAT_DIFF, load_obj, write_obj, load_ply, write_ply_binary,
    read_hdr, write_hdr, InteractiveCamera, procedural,
)


def test_scene_desc_reference_schema(tmp_path):
    # the exact schema of the reference data/sceneDesc.json
    js = {
        "scenefile": "data/TestObj.obj",
        "HDRmapname": "data/pisa.hdr",
        "textureFile": "data/Checker.png",
        "camFile": "data/newCamSetting.cam",
        "matCount": 5,
        "matDesc": {
            "InnerMat": {"refltype": "MAT_FRESNEL", "alphax": 0.1, "alphay": 0.1,
                         "objcol": [1.0, 1.0, 1.0], "kd": 5.0, "ks": 1.0},
            "OuterMat": {"refltype": "MAT_GLASS"},
            "LTELogo": {"refltype": "MAT_REFL"},
            "BackGroundMat": {"refltype": "MAT_DIFF", "useTexture": True},
            "Material": {"refltype": "MAT_REFL"},
        },
    }
    p = tmp_path / "sceneDesc.json"
    p.write_text(json.dumps(js))
    desc = load_scene_desc(str(p))
    assert desc.scenefile == "data/TestObj.obj"
    assert len(desc.materials) == 5
    assert desc.mat_id_map["InnerMat"] == 0
    assert desc.materials[0].refltype == MAT_FRESNEL
    assert desc.materials[0].kd == 5.0
    assert desc.materials[1].refltype == MAT_GLASS
    # defaults preserved (src/SceneDesc.h:18-32)
    assert desc.materials[1].etaT == pytest.approx(1.33)
    assert desc.materials[3].useTexture is True
    arrs = materials_to_arrays(desc.materials)
    assert arrs["refltype"].tolist() == [MAT_FRESNEL, MAT_GLASS, MAT_REFL, MAT_DIFF, MAT_REFL]
    np.testing.assert_allclose(arrs["F0"][0], (0.56, 0.57, 0.58))


def test_obj_roundtrip(tmp_path):
    mesh = procedural.make_test_scene()
    p = tmp_path / "scene.obj"
    write_obj(str(p), mesh, {0: "ground", 1: "inner", 2: "outer", 3: "logo"})
    back = load_obj(str(p), {"ground": 0, "inner": 1, "outer": 2, "logo": 3})
    assert back.num_triangles == mesh.num_triangles
    np.testing.assert_allclose(back.tri_vertices(), mesh.tri_vertices(), atol=1e-5)
    np.testing.assert_allclose(back.uv, mesh.uv, atol=1e-5)
    np.testing.assert_allclose(back.normals, mesh.normals, atol=1e-4)
    np.testing.assert_array_equal(back.material_ids, mesh.material_ids)


def test_obj_material_name_mapping(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("""
v 0 0 0
v 1 0 0
v 0 1 0
usemtl MatA
f 1 2 3
usemtl MatB
f 3 2 1
""")
    mesh = load_obj(str(p), {"MatA": 4, "MatB": 7})
    assert mesh.material_ids.tolist() == [4, 7]


def test_ply_binary_roundtrip(tmp_path):
    mesh = procedural.make_uv_sphere((0, 0, 0), 1.0, 0, n_lat=6, n_lon=8)
    p = tmp_path / "s.ply"
    write_ply_binary(str(p), mesh)
    back = load_ply(str(p))
    assert back.num_triangles == mesh.num_triangles
    np.testing.assert_allclose(back.tri_vertices(), mesh.tri_vertices(), atol=1e-5)
    # normals averaged per-vertex; direction should broadly agree
    dots = np.sum(back.normals * mesh.normals, axis=-1)
    assert np.mean(dots > 0.8) > 0.95


def test_hdr_roundtrip(tmp_path):
    env = procedural.make_sky_envmap(64, 32)
    p = tmp_path / "sky.hdr"
    write_hdr(str(p), env)
    back = read_hdr(str(p))
    assert back.shape == env.shape
    # RGBE has ~1% mantissa quantization
    rel = np.abs(back - env) / (np.abs(env) + 1e-3)
    assert np.percentile(rel, 99) < 0.02


def test_hdr_rle_decode(tmp_path):
    # build an RLE-compressed file by hand: constant scanlines compress to runs
    import struct
    w, h = 32, 4
    rgbe_val = (128, 64, 32, 129)  # some pixel
    with open(tmp_path / "r.hdr", "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        for _ in range(h):
            f.write(struct.pack("BBBB", 2, 2, 0, w))
            for c in range(4):
                f.write(struct.pack("BB", 128 + w, rgbe_val[c]))  # full run
    img = read_hdr(str(tmp_path / "r.hdr"))
    assert img.shape == (h, w, 3)
    scale = np.ldexp(1.0, 129 - 136)
    np.testing.assert_allclose(img[0, 0], np.array([128, 64, 32]) * scale, rtol=1e-6)
    assert np.all(img == img[0, 0])


def test_camera_orbit_and_cam_io(tmp_path):
    cam = InteractiveCamera()
    # defaults from src/Camera.cpp:9-22
    assert cam.pitch == pytest.approx(0.3)
    assert cam.radius == pytest.approx(5.0)
    rc = cam.build_render_camera()
    # eye = center + dir(yaw=0,pitch=.3)*5
    import math
    want_eye = (0.0, math.sin(0.3) * 5, math.cos(0.3) * 5)
    np.testing.assert_allclose(rc.position, want_eye, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(rc.view), -np.asarray(want_eye) / 5.0, atol=1e-6)
    # pitch clamp
    cam.change_pitch(10.0)
    assert cam.pitch == pytest.approx(math.pi / 2 - 0.05)
    # binary io roundtrip (64-byte reference format)
    cam.yaw = 1.25
    cam.save_cam(str(tmp_path / "c.cam"))
    assert (tmp_path / "c.cam").stat().st_size == 64
    back = InteractiveCamera.load_cam(str(tmp_path / "c.cam"))
    assert back.yaw == pytest.approx(1.25)
    assert back.pitch == pytest.approx(cam.pitch)


def test_reference_cam_file_parses(tmp_path):
    # a 64-byte file in the reference's newCamSetting.cam layout (16
    # little-endian f32: center xyz, view xyz, yaw, pitch, radius,
    # aperture, focal distance, env rotation, resolution xy, fov xy),
    # written byte by byte rather than through save_cam
    import struct
    vals = (0.0, 0.8, 0.0, 0.0, -0.3, -0.95, 0.35, 0.3, 4.5, 0.02, 4.0,
            0.25, 1920.0, 1080.0, 60.0, 33.75)
    path = tmp_path / "newCamSetting.cam"
    path.write_bytes(struct.pack("<16f", *vals))
    assert path.stat().st_size == 64
    cam = InteractiveCamera.load_cam(str(path))
    assert 0.2 <= cam.radius <= 100.0
    assert abs(cam.pitch) <= 1.55
    assert cam.resolution[0] > 0
    assert cam.yaw == pytest.approx(0.35)
    assert cam.radius == pytest.approx(4.5)
    assert tuple(cam.resolution) == (1920.0, 1080.0)
    assert cam.env_map_rotation == pytest.approx(0.25)


def test_hdr_old_style_runs(tmp_path):
    # old-style RLE: (1,1,1,count) repeats the previous pixel
    import struct
    w, h = 8, 2
    with open(tmp_path / "o.hdr", "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        for _ in range(h):
            f.write(struct.pack("BBBB", 100, 50, 25, 130))  # 1 literal pixel
            f.write(struct.pack("BBBB", 1, 1, 1, 7))        # repeat x7
    img = read_hdr(str(tmp_path / "o.hdr"))
    assert img.shape == (h, w, 3)
    assert np.all(img == img[0, 0])
    scale = np.ldexp(1.0, 130 - 136)
    np.testing.assert_allclose(img[0, 0], np.array([100, 50, 25]) * scale,
                               rtol=1e-6)


def test_reference_checker_png_loads(tmp_path):
    # a checker PNG like the reference's data/Checker.png (8-bit RGB),
    # encoded here chunk by chunk with rows under the Sub and Up filters
    import struct
    import zlib
    from tpu_pathtracer.scene.texture import load_texture
    n = 64
    cells = (np.indices((n, n)).sum(0) // 8) % 2
    img = np.repeat((cells * 255).astype(np.uint8)[..., None], 3, axis=2)
    rows = []
    for y in range(n):
        line = img[y].reshape(-1).astype(np.int32)
        if y % 2:                                   # Up
            prev = img[y - 1].reshape(-1).astype(np.int32)
            rows.append(bytes([2]) + bytes(((line - prev) & 0xFF).tolist()))
        else:                                       # Sub
            left = np.concatenate([[0, 0, 0], line[:-3]])
            rows.append(bytes([1]) + bytes(((line - left) & 0xFF).tolist()))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", n, n, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"".join(rows)))
           + chunk(b"IEND", b""))
    (tmp_path / "Checker.png").write_bytes(png)
    tex = load_texture(str(tmp_path / "Checker.png"))
    assert tex.ndim == 3 and tex.shape == (n, n, 3)
    assert tex.dtype == np.float32
    assert 0.0 <= tex.min() and tex.max() <= 1.0
    assert tex.std() > 0.1, "checker has contrast"
    np.testing.assert_array_equal(tex[..., 0] > 0.5, cells == 1)


def test_png_writer_roundtrips_through_decoder(tmp_path):
    from tpu_pathtracer.core.image import write_png
    from tpu_pathtracer.scene.texture import decode_png
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(
        decode_png((tmp_path / "a.png").read_bytes()), img)
    # accumulation + frame count -> tonemapped on the way out
    acc = np.full((4, 5, 3), 2.0, np.float32)
    write_png(str(tmp_path / "b.png"), acc, 8)
    got = decode_png((tmp_path / "b.png").read_bytes())
    assert np.all(got == int((0.25 ** (1 / 2.2)) * 255 + 0.5))


def test_png_decoder_rejects_unsupported_kinds():
    import struct
    import zlib
    from tpu_pathtracer.scene.texture import decode_png

    def png(depth, ctype, interlace):
        def chunk(tag, data):
            return (struct.pack(">I", len(data)) + tag + data
                    + struct.pack(">I", zlib.crc32(tag + data)))
        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, depth, ctype,
                                             0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(bytes(16)))
                + chunk(b"IEND", b""))
    for kind in ((8, 0, 0), (16, 2, 0), (8, 3, 0), (8, 2, 1)):
        with pytest.raises(ValueError, match="unsupported PNG"):
            decode_png(png(*kind))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


def _rle_encode_scanline(rgbe_row):
    """New-style RLE encoder (runs + literals), per the Radiance format the
    reference decrunches (src/HDRloader.cpp:116-160)."""
    w = rgbe_row.shape[0]
    out = bytearray([2, 2, (w >> 8) & 0xFF, w & 0xFF])
    for c in range(4):
        col = rgbe_row[:, c]
        x = 0
        while x < w:
            # find run length of equal bytes
            run = 1
            while x + run < w and col[x + run] == col[x] and run < 127:
                run += 1
            if run >= 4:
                out += bytes([128 + run, int(col[x])])
                x += run
            else:
                # literal chunk up to the next long run
                start = x
                while x < w and x - start < 128:
                    run = 1
                    while x + run < w and col[x + run] == col[x] and run < 127:
                        run += 1
                    if run >= 4:
                        break
                    x += run
                out += bytes([x - start]) + col[start:x].tobytes()
    return bytes(out)


def test_hdr_orientation_matches_reference_net_convention(tmp_path):
    """Pin the envmap orientation end to end against the reference's NET
    convention: HDRLoader::load appends decoded scanlines in FILE order
    (src/HDRloader.cpp:83-90 — the y loop is only a counter), initHDR's
    copy is an identity (src/main.cpp:388-397: idx2 = w*j+i from
    idx = 3*(w*j+i)), and envLight maps v = acos(dir.y)/pi with v=0 at
    buffer row 0 (src/renderkernel.cu:426-432). Net: the FIRST file
    scanline is the ZENITH row. A silent vertical flip here would blow the
    RMSE goal the moment a real pisa.hdr is used."""
    import jax.numpy as jnp
    from tpu_pathtracer.scene.hdr import read_hdr, _float_to_rgbe
    from tpu_pathtracer.scene.texture import make_quad_texture, \
        sample_envmap_quad

    H, W = 8, 16
    # power-of-two values -> exact through RGBE
    img = np.tile(np.float32([0.5, 1.0, 2.0]), (H, W, 1))
    img[1, 3] = [4.0, 0.25, 0.25]    # red marker near zenith
    img[6, 12] = [0.25, 4.0, 0.25]   # green marker near nadir
    rgbe = _float_to_rgbe(img)

    path = tmp_path / "marked.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (H, W))
        for y in range(H):
            f.write(_rle_encode_scanline(rgbe[y]))

    dec = read_hdr(str(path))
    # 1) RLE decodes exactly, rows in file order
    np.testing.assert_array_equal(dec, img)

    # 2) reference-pipeline emulation: scanlines appended in file order
    #    (buffer row j = file scanline j) must equal our rows
    np.testing.assert_array_equal(dec[0], img[0])

    # 3) direction-level golden: the texel centers land at the right (θ,φ)
    quad = jnp.asarray(make_quad_texture(dec, wrap_u=False, wrap_v=False))

    def dir_of(row, col):
        v = (row + 0.5) / H
        u = (col + 0.5) / W
        theta, phi = v * np.pi, u * 2 * np.pi
        return np.float32([np.sin(theta) * np.sin(phi), np.cos(theta),
                           np.sin(theta) * np.cos(phi)])

    dirs = jnp.asarray(np.stack([dir_of(1, 3), dir_of(6, 12),
                                 [0.0, 1.0, 0.0]]))
    out = np.asarray(sample_envmap_quad(quad, H, W, dirs, 0.0))
    assert out[0, 0] > 2.0 and out[0, 1] < 1.0, "red marker misplaced"
    assert out[1, 1] > 2.0 and out[1, 0] < 1.0, "green marker misplaced"
    # up-ray reads the FIRST file scanline (background there)
    np.testing.assert_allclose(out[2], [0.5, 1.0, 2.0], atol=1e-5)
