"""CLI (python -m tpu_blosc) smoke tests — library-only upstream, CLI is
framework-surface plus."""

import numpy as np
import pytest

import tpu_blosc as blosc
from tpu_blosc.__main__ import main


@pytest.fixture
def sample(tmp_path):
    p = tmp_path / "data.bin"
    p.write_bytes(np.arange(50_000, dtype=np.float32).tobytes())
    return p


def test_cli_compress_decompress_roundtrip(sample, tmp_path, capsys):
    out = tmp_path / "data.bl2"
    assert main(["compress", str(sample), "-o", str(out)]) == 0
    assert "ratio" in capsys.readouterr().out
    dec = tmp_path / "data.out"
    assert main(["decompress", str(out), "-o", str(dec)]) == 0
    assert dec.read_bytes() == sample.read_bytes()


def test_cli_codec_options(sample, tmp_path):
    out = tmp_path / "z.bl2"
    assert main([
        "compress", str(sample), "-o", str(out),
        "--codec", "zstd", "--level", "7", "--shuffle", "bit",
        "--typesize", "4", "--block", "16384",
    ]) == 0
    h = blosc.get_info(out.read_bytes())
    assert h.codec == blosc.ZSTD
    assert h.has_bitshuffle and h.is_split


def test_cli_auto(sample, tmp_path, capsys):
    out = tmp_path / "a.bl2"
    assert main(["compress", str(sample), "-o", str(out), "--auto"]) == 0
    dec = tmp_path / "a.out"
    assert main(["decompress", str(out), "-o", str(dec)]) == 0
    assert dec.read_bytes() == sample.read_bytes()


def test_cli_auto_honors_level_without_block(sample, tmp_path, monkeypatch):
    """Regression (round-2 advisor): ``--auto --level 9`` silently used
    the default level unless --block was also given."""
    import tpu_blosc.__main__ as cli

    seen = {}
    real = cli.compress_with_options

    def spy(data, opts):
        seen["opts"] = opts
        return real(data, opts)

    monkeypatch.setattr(cli, "compress_with_options", spy)
    out = tmp_path / "a.bl2"
    assert main([
        "compress", str(sample), "-o", str(out), "--auto", "--level", "9",
    ]) == 0
    assert seen["opts"].level == 9


def test_cli_info(sample, tmp_path, capsys):
    out = tmp_path / "i.bl2"
    main(["compress", str(sample), "-o", str(out)])
    capsys.readouterr()
    assert main(["info", str(out)]) == 0
    text = capsys.readouterr().out
    assert "uncompressed: 200,000 bytes" in text
    assert "ratio" in text


def test_cli_suggest(sample, capsys):
    assert main(["suggest", str(sample), "--typesize", "4"]) == 0
    text = capsys.readouterr().out
    assert "--codec" in text and "--shuffle byte" in text


def test_cli_module_invocation(sample, tmp_path):
    import subprocess, sys, os

    out = tmp_path / "m.bl2"
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # host-only smoke test: the CLI must not need a device
    env["TPU_BLOSC_NO_DEVICE"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_blosc", "compress", str(sample),
         "-o", str(out)],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert out.exists()


def test_cli_pack_unpack_roundtrip(tmp_path, capsys):
    arr = np.arange(3000, dtype=np.float64).reshape(50, 60)
    src = tmp_path / "arr.npy"
    np.save(src, arr)
    packed = tmp_path / "arr.tpba"
    assert main(["pack", str(src), "-o", str(packed),
                 "--codec", "zstd", "--shuffle", "bit"]) == 0
    assert "dtype float64" in capsys.readouterr().out
    out = tmp_path / "back.npy"
    assert main(["unpack", str(packed), "-o", str(out)]) == 0
    assert np.array_equal(np.load(out), arr)


def test_cli_verify_stream(tmp_path, capsys):
    from tpu_blosc.stream import StreamWriter

    path = tmp_path / "s.tpbs"
    with StreamWriter(path, checksum=True) as w:
        w.write(b"payload" * 500)
        w.write(b"more" * 800)
    assert main(["verify", str(path)]) == 0
    out = capsys.readouterr().out
    assert "2 records ok" in out and "crc32-checked" in out
    assert main(["verify", str(path), "--deep"]) == 0
    # corrupt a payload byte: verify must fail with rc 1
    blob = bytearray(path.read_bytes())
    blob[30] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert main(["verify", str(path)]) == 1


def test_cli_compress_blosclz(sample, tmp_path, capsys):
    out = tmp_path / "b.bl2"
    assert main([
        "compress", str(sample), "-o", str(out), "--codec", "blosclz",
    ]) == 0
    dec = tmp_path / "b.out"
    assert main(["decompress", str(out), "-o", str(dec)]) == 0
    assert dec.read_bytes() == sample.read_bytes()


def test_cli_compress_multiple_files(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(np.arange(5000 + i, dtype=np.float32).tobytes())
        paths.append(p)
    rc = main(["compress", *map(str, paths)])
    assert rc == 0
    for p in paths:
        out = tmp_path / (p.name + ".bl2")
        assert blosc.decompress(out.read_bytes()) == p.read_bytes()
    rc = main(["decompress", *(str(p) + ".bl2" for p in paths)])
    assert rc == 0
    for p in paths:
        assert (tmp_path / (p.name + ".bl2.out")).read_bytes() == p.read_bytes()


def test_cli_multi_input_with_output_rejected(tmp_path, capsys):
    a = tmp_path / "a.bin"
    b = tmp_path / "b.bin"
    a.write_bytes(b"aa" * 100)
    b.write_bytes(b"bb" * 100)
    rc = main(["compress", str(a), str(b), "-o", str(tmp_path / "x")])
    assert rc == 2
    assert "single input" in capsys.readouterr().err
