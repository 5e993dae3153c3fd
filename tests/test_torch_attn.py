"""The port's gene-gene attention extraction against the JAX package's, on
the CPU in float32.

``GeneAttnExtractor`` on flax parameters carried across (the attention
stack within 1e-5, ``rna_core`` equal), the extractor's weights out of a
UNet both ways, ``GeneGeneBlock.attention`` against ``forward``'s matrix,
``pathway_products`` bit-equal, and ``cli.attn`` end to end against JAX's
on one reference ``.ckpt`` (tiles within one float16 spacing,
``attn_ensemble.npy`` within 1e-5): ROI mode, the figures, the card
default, the gene directory of ``--mouse``, and the gene-name assets.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_convert import TINY
from test_torch_io import f32_tree, port_tiny_conf, ref_state_dict  # noqa: F401
from test_torch_models import seeded_params

from tera_mind_tpu.cli import attn as jcli
from tera_mind_tpu.constants import MROI as JMROI
from tera_mind_tpu.models import attention as jattn
from tera_mind_tpu.models import unet_attn as jua
from tera_mind_tpu_torch.cli import attn as tcli
from tera_mind_tpu_torch.cli import generate as tgen_cli
from tera_mind_tpu_torch.config import TrainConfig
from tera_mind_tpu_torch.convert import load_jax_params
from tera_mind_tpu_torch.data.tilestore import TileStore
from tera_mind_tpu_torch.models import attention as tattn
from tera_mind_tpu_torch.models import unet_attn as tua

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread (several pytest workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gene_dense(rng, b, gn, z, g=500):
    """Sparse integer gene counts (B, gn, gn, z * g), float32."""
    shape = (b, gn, gn, z * g)
    return (rng.integers(1, 5, shape) * (rng.random(shape) < 0.1)).astype(
        np.float32)


@pytest.mark.parametrize("rna_num", [20, 229])
@pytest.mark.parametrize("z_rna", [4, 8])
def test_extractor_matches_jax(rna_num, z_rna):
    x = gene_dense(np.random.default_rng(z_rna + rna_num), 3, 4, z_rna)
    jm = jua.GeneAttnExtractor(rna_num=rna_num, z_rna=z_rna, gn_sz=4)
    p = seeded_params(jm, x, seed=1)
    want_attn, want_core = jm.apply(p, x)
    tm = load_jax_params(tua.GeneAttnExtractor(rna_num, z_rna, 4), p)
    with torch.no_grad():
        got_attn, got_core = tm(torch.from_numpy(x))
    assert got_attn.shape == (z_rna, 3, rna_num, rna_num)
    assert got_attn.dtype == torch.float32
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_core.numpy(), np.asarray(want_core))


def test_extractor_state_from_unet_matches_jax():
    """The port's UNet -> extractor slice fills the same extractor as
    JAX's ``extractor_params_from_unet`` on the same tiny UNet tree."""
    jconf = TINY
    p = f32_tree(seeded_params(
        jconf.make_model(), np.zeros((4, 32, 32, 4), np.float32),
        np.zeros((1,), np.int32), np.zeros((4, 2, 2, 64), np.float32), 2, 2,
        seed=3))
    unet = load_jax_params(port_tiny_conf().make_model(), p)
    want = load_jax_params(tua.GeneAttnExtractor(16, 4, 2),
                           jua.extractor_params_from_unet(p))
    for src in (unet, dict(unet.named_parameters())):
        got = tua.GeneAttnExtractor(16, 4, 2)
        got.load_state_dict(tua.extractor_state_from_unet(src))
        for (n, a), (m, b) in zip(got.state_dict().items(),
                                  want.state_dict().items()):
            assert n == m
            assert torch.equal(a, b), n
    # the flax-tree slice is JAX's
    mine = tua.extractor_params_from_unet(p)["params"]["gene_attn"]
    assert mine is p["params"]["rna_tower"]["gene_attn"]
    with pytest.raises(KeyError):
        tua.extractor_state_from_unet({"out_conv.weight": torch.zeros(1)})


def test_gene_block_attention_is_forwards_matrix():
    rng = np.random.default_rng(15)
    rna = rng.standard_normal((3, 4, 2, 2, 9)).astype(np.float32)
    jm = jattn.GeneGeneBlock(hidden_size=16, z_size=4)
    p = seeded_params(jm, rna, seed=16)
    tm = load_jax_params(tattn.GeneGeneBlock(16, 4, 9), p)
    with torch.no_grad():
        _, from_forward = tm(torch.from_numpy(rna), return_attn=True)
        alone = tm.attention(torch.from_numpy(rna))
    assert alone.shape == (3, 1, 9, 9) and alone.dtype == torch.float32
    assert torch.equal(alone, from_forward)


def test_pathway_products_bit_equal():
    rng = np.random.default_rng(0)
    attn = rng.random((12, 12)).astype(np.float32)
    expr = rng.random((4, 4, 12)).astype(np.float32)
    glst = np.array([1, 4, 7, 11])
    got = tcli.pathway_products(attn, expr, glst)
    want = jcli.pathway_products(attn, expr, glst)
    assert got.dtype == want.dtype and got.shape == (4, 4, 8)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# the CLI                                                                 #
# --------------------------------------------------------------------- #
def tiny_train_config(mouse: str = "638850") -> TrainConfig:
    """The training config of test_convert.py's TINY UNet."""
    return TrainConfig(mouse=mouse, image_size=32, rna_num=16, rna_slices=4,
                       stain="all", net_ch=8, embed_channels=32, dropout=0.0)


def write_ckpt(run: Path, sd: dict, mouse: str = "638850") -> Path:
    run.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": {
        f"model.{k}": torch.from_numpy(np.ascontiguousarray(v))
        for k, v in sd.items()}}, run / "last.ckpt")
    tiny_train_config(mouse).save(run / "config.json")
    return run / "last.ckpt"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, ref_state_dict):  # noqa: F811
    """Both CLIs' ``--calc_attn --synthetic`` on a 2x2 grid from one
    reference checkpoint (the port with ``--device cpu``)."""
    tmp = tmp_path_factory.mktemp("attn")
    ckpt = write_ckpt(tmp / "run", ref_state_dict)
    argv = ["--calc_attn", "--synthetic", "--hnm", "2", "--wnm", "2",
            "--ckpt_pth", str(ckpt)]
    old = sys.argv
    sys.argv = ["attn"] + argv + ["--out_dir", str(tmp / "jax")]
    try:
        jcli.main()
    finally:
        sys.argv = old
    rec = tcli.main(argv + ["--out_dir", str(tmp / "port"), "--device",
                            "cpu"])
    return tmp, rec


def test_cli_matches_jax(cli_runs):
    tmp, rec = cli_runs
    port, jax_ = TileStore(tmp / "port"), TileStore(tmp / "jax")
    names = [n for n in jax_.names() if n[0].isdigit()]
    assert len(names) == 4 and rec["names"] == sorted(names, key=lambda n: (
        int(n.split("_")[0]), int(n.split("_")[2])))
    np.testing.assert_array_equal(rec["glst"], [0, 1])
    for n in names:
        got, want = port.read(n), jax_.read(n)
        assert got.dtype == want.dtype == np.float16
        assert got.shape == want.shape == (4, 16, 16, 4)
        # within one float16 spacing of the JAX tile
        gap = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert (gap <= np.spacing(np.abs(want))).all(), (n, gap.max())
    got = np.load(tmp / "port" / "attn_ensemble.npy")
    want = np.load(tmp / "jax" / "attn_ensemble.npy")
    assert got.shape == want.shape == (16, 16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_cli_vis_writes_the_three_figure_families(cli_runs, monkeypatch):
    tmp, _ = cli_runs
    tcli.main(["--is_vis", "--out_dir", str(tmp / "port")])
    vis = tmp / "port" / "vis"
    assert len(list(vis.glob("group*_ch*.png"))) == 4 * 4
    assert len(list(vis.glob("joint_ch*.png"))) == 2
    assert len(list(vis.glob("surface_ch*.png"))) == 2
    # without matplotlib, --is_vis exits naming it
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        tcli.main(["--is_vis", "--out_dir", str(tmp / "port")])


@pytest.mark.parametrize("roi", [0, 3])
def test_roi_mode_picks_jaxs_region(monkeypatch, roi):
    """``--pathway ROI`` sets JAX's origin and grid from MROI, and selects
    its genes by the panel's names."""
    seen = {}
    monkeypatch.setattr(jcli, "_calc", lambda args, conf: seen.update(
        jax=(args.hst, args.wst, args.hnm, args.wnm)))
    monkeypatch.setattr(tcli, "calc", lambda args, conf: seen.update(
        port=(args.hst, args.wst, args.hnm, args.wnm)))
    argv = ["--calc_attn", "--pathway", "ROI", "--roi", str(roi)]
    monkeypatch.setattr(sys, "argv", ["attn"] + argv)
    jcli.main()
    tcli.main(argv + ["--device", "cpu"])
    assert seen["port"] == seen["jax"]
    assert seen["port"][2:] == (16, 16)
    args = tcli.parse_args(argv)
    tcli.apply_roi(args)
    names = jcli._gene_names("638850")
    want = [names.index(g) for g in JMROI["638850"][3][roi]]
    np.testing.assert_array_equal(
        tcli.pathway_genes(args, TrainConfig(rna_num=229)), want)
    with pytest.raises(SystemExit, match="out of range"):
        tcli.main(["--pathway", "ROI", "--roi", "7"])


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["--calc_attn", "--synthetic", "--hnm", "1", "--wnm", "1"])


@pytest.mark.parametrize("cli", ["generate", "attn"])
def test_gene_directory_follows_mouse_flag(tmp_path, ref_state_dict,  # noqa: F811
                                           monkeypatch, cli):
    """With a checkpoint trained on another mouse (its config.json says
    609882), the gene files are read from ``--mouse``'s directory, as the
    JAX CLIs read them."""
    ckpt = write_ckpt(tmp_path / "run", ref_state_dict, mouse="609882")
    seen = []

    def provider(gdir, hst, wst, *, gdim, spad):
        seen.append(str(gdir))
        return lambda r, c: np.zeros((20, 20, 52, gdim), np.float32)

    mod = tgen_cli if cli == "generate" else tcli
    monkeypatch.setattr(mod, "gene_provider", provider)
    argv = ["--mouse", "638850", "--ckpt_pth", str(ckpt), "--hnm", "1",
            "--wnm", "1", "--device", "cpu"]
    if cli == "generate":
        tgen_cli.build(tgen_cli.parse_args(argv))
    else:
        tcli.main(argv + ["--calc_attn", "--out_dir", str(tmp_path / "o")])
    assert seen == ["Data/MERFISH_50/gene_638850"]


@pytest.mark.parametrize("name", ["63885_gnm.csv", "60988_gnm.csv"])
def test_gene_name_assets_equal_jaxs(name):
    mine = ROOT / "tera_mind_tpu_torch" / "assets" / name
    assert mine.read_bytes() == (ROOT / "tera_mind_tpu" / "assets" /
                                 name).read_bytes()
    assert tcli._gene_names(name[:5] + "0")[:3] == jcli._gene_names(
        name[:5] + "0")[:3]
