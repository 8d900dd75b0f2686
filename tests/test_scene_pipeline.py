"""End-to-end: sceneDesc.json -> loaders -> renderer (the reference's full
main() startup path, src/main.cpp:672-760)."""
import json
import os

import numpy as np

from tpu_pathtracer.scene import procedural, write_obj, write_hdr
from tpu_pathtracer.scene.camera import InteractiveCamera
from tpu_pathtracer.scene.config import load_scene_desc
from tpu_pathtracer.tracer.renderer import renderer_from_scene_desc
from tpu_pathtracer.scene.demo import default_camera


def test_scene_desc_to_render(tmp_path):
    # assets on disk, exactly like the reference data/ directory
    mesh = procedural.make_test_scene()
    write_obj(str(tmp_path / "scene.obj"), mesh,
              {0: "BackGroundMat", 1: "InnerMat", 2: "OuterMat", 3: "LTELogo"})
    write_hdr(str(tmp_path / "sky.hdr"), procedural.make_sky_envmap(64, 32))
    from tpu_pathtracer.core.image import write_png
    tex = (procedural.make_checker_texture(64) * 255).astype(np.uint8)
    write_png(str(tmp_path / "checker.png"), tex)
    cam = default_camera(64, 64)
    cam.save_cam(str(tmp_path / "cam.cam"))

    desc = {
        "scenefile": "scene.obj",
        "HDRmapname": "sky.hdr",
        "textureFile": "checker.png",
        "camFile": "cam.cam",
        "matCount": 4,
        "width": 64, "height": 64,
        "matDesc": {
            "InnerMat": {"refltype": "MAT_FRESNEL", "alphax": 0.1,
                         "alphay": 0.1, "kd": 5.0, "ks": 1.0},
            "OuterMat": {"refltype": "MAT_GLASS"},
            "LTELogo": {"refltype": "MAT_REFL"},
            "BackGroundMat": {"refltype": "MAT_DIFF", "useTexture": True},
        },
    }
    (tmp_path / "sceneDesc.json").write_text(json.dumps(desc))

    loaded = load_scene_desc(str(tmp_path / "sceneDesc.json"))
    r = renderer_from_scene_desc(loaded, base_dir=str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"))
    icam = InteractiveCamera.load_cam(str(tmp_path / "cam.cam"))
    rc = icam.build_render_camera()
    accum = r.render_frames(r.zeros_accum(), rc, 1, 4)
    img = r.accum_to_buffer(np.asarray(accum) / 4)
    assert np.all(np.isfinite(img))
    assert img.mean() > 0.05, "scene renders light"
    assert img.std() > 0.05, "scene has structure (not flat env)"
