"""tests/test_image.py on the port: ``repro_torch.core.{image,imagefile,
registry}`` against the JAX package's, on the CPU.

Every test of tests/test_image.py runs its own body on the port through
``torch_ref.check_both`` (one port test a reference test, named in its
docstring): the body's ``EnvImage``, ``ImageBuilder``, ``Layer``,
``parse_imagefile``, ``render_imagefile``, ``Registry`` and the two error
classes are the port's, and a body that still reaches the JAX package
fails. The hypothesis property tests run with their own strategies and
settings. Beside them, the digests the bodies build are held to the JAX
package's: an image is content-addressed by canonical JSON, so the port's
digest of the same layers is the reference's, byte for byte.
"""

import pytest

import test_image as ref
import torch_ref

from repro.core.image import ImageBuilder as JBuilder
from repro.core.image import Layer as JLayer
from repro.core.imagefile import parse_imagefile as j_parse
from repro_torch.core.image import ImageBuilder, Layer
from repro_torch.core.imagefile import parse_imagefile


def _tmp(tmp_path):
    """A fresh directory for each package's run of a body."""
    def args(pkg, port):
        d = tmp_path / ("torch" if port else "jax")
        d.mkdir()
        return (d,)
    return args


def test_same_build_same_digest():
    """Mirrors test_image.py::test_same_build_same_digest."""
    torch_ref.check_both(ref, "test_same_build_same_digest")


def test_any_payload_change_changes_digest():
    """Mirrors test_image.py::test_any_payload_change_changes_digest."""
    torch_ref.check_both(ref, "test_any_payload_change_changes_digest")


def test_layer_chain_integrity_enforced():
    """Mirrors test_image.py::test_layer_chain_integrity_enforced."""
    torch_ref.check_both(ref, "test_layer_chain_integrity_enforced")


def test_derived_image_shares_layer_objects():
    """Mirrors test_image.py::test_derived_image_shares_layer_objects."""
    torch_ref.check_both(ref, "test_derived_image_shares_layer_objects")


def test_property_digest_deterministic_and_order_free():
    """Mirrors test_image.py::
    test_property_digest_deterministic_and_order_free (its strategy and
    settings: 50 examples, no deadline)."""
    torch_ref.check_both(ref,
                         "test_property_digest_deterministic_and_order_free")


def test_property_different_payload_different_digest():
    """Mirrors test_image.py::
    test_property_different_payload_different_digest (30 examples)."""
    torch_ref.check_both(ref,
                         "test_property_different_payload_different_digest")


def test_imagefile_parse_and_config():
    """Mirrors test_image.py::test_imagefile_parse_and_config."""
    torch_ref.check_both(ref, "test_imagefile_parse_and_config")


def test_imagefile_roundtrip_preserves_digest():
    """Mirrors test_image.py::test_imagefile_roundtrip_preserves_digest."""
    torch_ref.check_both(ref, "test_imagefile_roundtrip_preserves_digest")


def test_imagefile_rejects_garbage():
    """Mirrors test_image.py::test_imagefile_rejects_garbage."""
    torch_ref.check_both(ref, "test_imagefile_rejects_garbage")


def test_imagefile_from_registry_tag(tmp_path):
    """Mirrors test_image.py::test_imagefile_from_registry_tag."""
    torch_ref.check_both(ref, "test_imagefile_from_registry_tag",
                         args=_tmp(tmp_path))


def test_registry_push_pull_roundtrip(tmp_path):
    """Mirrors test_image.py::test_registry_push_pull_roundtrip."""
    torch_ref.check_both(ref, "test_registry_push_pull_roundtrip",
                         args=_tmp(tmp_path))


def test_registry_layer_dedupe(tmp_path):
    """Mirrors test_image.py::test_registry_layer_dedupe."""
    torch_ref.check_both(ref, "test_registry_layer_dedupe",
                         args=_tmp(tmp_path))


def test_registry_detects_corruption(tmp_path):
    """Mirrors test_image.py::test_registry_detects_corruption."""
    torch_ref.check_both(ref, "test_registry_detects_corruption",
                         args=_tmp(tmp_path))


def test_registry_unknown_ref(tmp_path):
    """Mirrors test_image.py::test_registry_unknown_ref."""
    torch_ref.check_both(ref, "test_registry_unknown_ref",
                         args=_tmp(tmp_path))


@pytest.mark.parametrize("build", ["basic", "derived", "imagefile"])
def test_digests_equal_the_reference(build):
    """The images the bodies above build have the JAX package's digests,
    layer by layer: ``build_basic``'s, its ``SET remat=dots`` child's and
    ``IMAGEFILE``'s (and its rendered Imagefile's text)."""
    def make(builder, parse):
        if build == "imagefile":
            return parse(ref.IMAGEFILE)
        img = (builder.from_scratch().arch("llama3.2-3b").shape("train_4k")
               .mesh("pod").collectives("generic").build())
        if build == "derived":
            img = builder.from_image(img).set(remat="dots").build()
        return img
    j, t = make(JBuilder, j_parse), make(ImageBuilder, parse_imagefile)
    assert t.digest == j.digest
    assert [x.digest for x in t.layers] == [x.digest for x in j.layers]
    assert Layer(kind="set", payload={"a": 1}).digest == \
        JLayer(kind="set", payload={"a": 1}).digest
    if build == "imagefile":
        from repro.core.imagefile import render_imagefile as j_render
        from repro_torch.core.imagefile import render_imagefile
        assert render_imagefile(t) == j_render(j)
