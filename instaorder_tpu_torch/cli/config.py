"""YAML experiment config loading (counterpart of
instaorder_tpu/cli/config.py).

Same schema as the reference's experiments/*/*/config.yaml (three
sections: model / data / trainer) including the magic base_dir rewrite:
any string value containing '/data/' is prefixed with base_dir
(reference main.py:16-25, duplicated tools/test.py:60-66). PyYAML is
imported by `load_config` only, so the rest of the port runs where it is
not installed.
"""

from __future__ import annotations

from types import SimpleNamespace


def rewrite_paths(section: dict, base_dir: str) -> dict:
    out = {}
    for k, v in section.items():
        if isinstance(v, str) and '/data/' in v:
            out[k] = base_dir + v
        else:
            out[k] = v
    return out


def load_config(path: str):
    """Returns a namespace with .model/.data/.trainer dicts (+ raw)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError('cli.config.load_config needs the PyYAML package '
                          '(yaml) to read a config file') from e
    with open(path) as f:
        raw = yaml.safe_load(f)
    base_dir = raw.get('data', {}).get('base_dir', '')
    ns = SimpleNamespace()
    for section, content in raw.items():
        if isinstance(content, dict):
            content = rewrite_paths(content, base_dir)
        setattr(ns, section, content)
    ns.raw = raw
    return ns
