"""HF-format checkpoint import and export for the port (own copy of
``skypilot_tpu/models/weights.py``).

Maps a HuggingFace checkpoint directory (``config.json`` +
``*.safetensors`` [+ index]) of the Llama, Mistral, Gemma, Qwen2 and
Mixtral families onto the stacked-layer param dict of ``models/llama.py``, and
writes one back. Layouts as in the reference: HF's per-layer ``[out,
in]`` Linear matrices become input-major leaves stacked on a leading
``[L]`` axis (Mixtral's per-expert matrices into ``[L, E, ...]``
buffers); the rope convention is already HF's (rotate-half); norms and
q/k/v biases stay fp32, matmul weights take ``cfg.dtype``.

The safetensors format is read and written here without the
``safetensors`` package (the card's machine has none): a u64
little-endian header length, a JSON header of ``{name: {dtype, shape,
data_offsets}}``, then the raw little-endian tensors. The reader hands
out zero-copy views of a ``numpy.memmap`` (bf16, which numpy lacks,
through ``torch.frombuffer``); the writer streams one tensor at a time.

``quantize='int8'`` (or ``'int4'``: packed dense leaves, int8 expert
leaves) quantizes the matmul weights on the host, one layer slice (one
expert) at a time from the checkpoint's own values, with the
reference's rounded-scale contract, so only codes and scales reach the
device; :func:`load_checkpoint` caches the quantized tree next to the
checkpoint in the reference's format (``.int8_cache.bin`` or
``.int4_cache.bin`` + ``.meta.json``, version 2, 128-byte-aligned
leaves, packed leaves named ``.int4``, the same fingerprint), so a
cache written by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import quantization
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.convert import FP32_KEYS, param_keys
from skypilot_tpu_torch.models.quantization import (QUANT_LEAF_TYPES,
                                                    QuantizedWeight,
                                                    QuantizedWeight4)
from skypilot_tpu_torch.utils.device import DeviceLike, resolve_device

Params = Dict[str, Any]

# ------------------------------------------------------------ safetensors
_ST_DTYPES = {'F16': torch.float16, 'BF16': torch.bfloat16,
              'F32': torch.float32, 'I8': torch.int8, 'U8': torch.uint8,
              'I32': torch.int32, 'I64': torch.int64}
_ST_CODES = {v: k for k, v in _ST_DTYPES.items()}
_MAX_HEADER = 100 << 20


def _as_tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a`` (numpy or torch), C-contiguous."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.detach().cpu().contiguous()


class _SafetensorsFile:
    """One safetensors file, memory-mapped: ``header`` maps each name to
    (dtype, shape, begin, end) with offsets absolute in the file."""

    def __init__(self, fname: str):
        self.fname = fname
        with open(fname, 'rb') as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f'{fname}: not a safetensors file')
            (n,) = struct.unpack('<Q', head)
            if n > _MAX_HEADER:
                raise ValueError(f'{fname}: header of {n} bytes')
            meta = json.loads(f.read(n).decode('utf-8'))
        size = os.path.getsize(fname)
        start = 8 + n
        self.header: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        for name, e in meta.items():
            if name == '__metadata__':
                continue
            code, shape = e['dtype'], tuple(int(s) for s in e['shape'])
            if code not in _ST_DTYPES:
                raise ValueError(f'{fname}: tensor {name!r} has dtype '
                                 f'{code}; supported: {sorted(_ST_DTYPES)}')
            b, en = (int(o) for o in e['data_offsets'])
            want = int(np.prod(shape, dtype=np.int64)) * \
                _ST_DTYPES[code].itemsize
            if en - b != want or b < 0 or start + en > size:
                raise ValueError(f'{fname}: tensor {name!r} offsets {b}:{en} '
                                 f'do not hold {code}{list(shape)}')
            self.header[name] = (code, shape, start + b, start + en)
        # Copy-on-write: writable views (torch warns on read-only
        # buffers) that never write back to the file.
        self._mm = (np.memmap(fname, dtype=np.uint8, mode='c')
                    if size > start else np.zeros(0, np.uint8))

    def keys(self) -> List[str]:
        return list(self.header)

    def tensor(self, name: str) -> torch.Tensor:
        """Tensor ``name`` as a CPU view of the mapped file (a copy only
        when its offset is not aligned to its element size)."""
        code, shape, b, en = self.header[name]
        dtype = _ST_DTYPES[code]
        n = (en - b) // dtype.itemsize
        if n == 0:
            return torch.empty(shape, dtype=dtype)
        if b % dtype.itemsize:
            raw = torch.from_numpy(np.array(self._mm[b:en]))
            return raw.view(dtype).reshape(shape)
        return torch.frombuffer(self._mm, dtype=dtype, count=n,
                                offset=b).reshape(shape)


class _SafetensorsWriter:
    """Streams one safetensors file: the header is written first from
    ``specs`` ([(name, torch dtype, shape)] in file order), then each
    tensor at its offset as :meth:`write` receives it, in any order;
    :meth:`close` checks that every tensor was written."""

    def __init__(self, fname: str, specs):
        header: Dict[str, Any] = {}
        off = 0
        self._specs: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int]] = {}
        for name, dtype, shape in specs:
            shape = tuple(int(s) for s in shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            header[name] = {'dtype': _ST_CODES[dtype], 'shape': list(shape),
                            'data_offsets': [off, off + nbytes]}
            self._specs[name] = (dtype, shape, off)
            off += nbytes
        blob = json.dumps(header, separators=(',', ':')).encode('utf-8')
        blob += b' ' * (-len(blob) % 8)        # data starts 8-aligned
        self._start = 8 + len(blob)
        self._f = open(fname, 'wb')
        self._f.write(struct.pack('<Q', len(blob)) + blob)
        self._f.truncate(self._start + off)
        self._written = set()

    def write(self, name: str, a) -> None:
        dtype, shape, off = self._specs[name]
        t = _as_tensor(a)
        if (t.dtype, tuple(t.shape)) != (dtype, shape) or \
                name in self._written:
            raise ValueError(f'safetensors writer: {name!r} {t.dtype} '
                             f'{tuple(t.shape)} (written before: '
                             f'{name in self._written}), expected {dtype} '
                             f'{shape}')
        if t.numel():
            self._f.seek(self._start + off)
            self._f.write(memoryview(t.view(torch.uint8).numpy()))
        self._written.add(name)

    def close(self) -> None:
        self._f.close()
        missing = sorted(set(self._specs) - self._written)
        if missing:
            raise ValueError(f'safetensors writer: {len(missing)} tensors '
                             f'not written, first: {missing[:4]}')

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self._f.close()


# ------------------------------------------------------------ HF config
_ARCH_FAMILY = {
    'LlamaForCausalLM': 'llama',
    'MistralForCausalLM': 'llama',
    'GemmaForCausalLM': 'gemma',
    'MixtralForCausalLM': 'mixtral',
    'Qwen2ForCausalLM': 'qwen2',
}


def config_from_hf(hf: Dict[str, Any], name: Optional[str] = None,
                   dtype: torch.dtype = torch.bfloat16) -> ModelConfig:
    """Build a ModelConfig from an HF ``config.json`` dict (the MoE
    capacity factor is the config default, as in the reference)."""
    archs = hf.get('architectures') or []
    family = next((_ARCH_FAMILY[a] for a in archs if a in _ARCH_FAMILY),
                  None)
    if family is None:
        raise ValueError(
            f'Unsupported architectures {archs!r}; supported: '
            f'{sorted(_ARCH_FAMILY)}')
    dim = hf['hidden_size']
    n_heads = hf['num_attention_heads']
    head_dim = hf.get('head_dim')
    kw: Dict[str, Any] = dict(
        name=name or hf.get('model_type', family),
        vocab_size=hf['vocab_size'],
        dim=dim,
        n_layers=hf['num_hidden_layers'],
        n_heads=n_heads,
        n_kv_heads=hf.get('num_key_value_heads', n_heads),
        ffn_dim=hf['intermediate_size'],
        max_seq_len=hf.get('max_position_embeddings', 8192),
        rope_theta=float(hf.get('rope_theta', 10000.0)),
        norm_eps=float(hf.get('rms_norm_eps', 1e-5)),
        dtype=dtype,
        tie_embeddings=bool(hf.get('tie_word_embeddings', False)),
    )
    if head_dim is not None and head_dim != dim // n_heads:
        kw['head_dim_override'] = head_dim
    if family == 'gemma':
        kw.update(tie_embeddings=True, activation='gelu',
                  norm_plus_one=True, scale_embeddings=True)
    if family == 'qwen2':
        kw.update(qkv_bias=True)
    if family == 'mixtral':
        kw.update(n_experts=hf['num_local_experts'],
                  n_experts_per_token=hf.get('num_experts_per_tok', 2))
    return ModelConfig(**kw)


def _read_hf_config(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, 'config.json'), encoding='utf-8') as f:
        return json.load(f)


def _safetensor_files(path: str) -> List[str]:
    """The checkpoint's shards: from the index file, else the single
    ``model.safetensors``, else every ``*.safetensors`` in the
    directory."""
    index = os.path.join(path, 'model.safetensors.index.json')
    if os.path.exists(index):
        with open(index, encoding='utf-8') as f:
            weight_map = json.load(f)['weight_map']
        return sorted({os.path.join(path, v) for v in weight_map.values()})
    single = os.path.join(path, 'model.safetensors')
    if os.path.exists(single):
        return [single]
    files = sorted(f for f in os.listdir(path) if f.endswith('.safetensors'))
    if not files:
        raise FileNotFoundError(f'No .safetensors files under {path}')
    return [os.path.join(path, f) for f in files]


def load_workers() -> int:
    """Checkpoint-load parallelism (threads copying tensors out of the
    mapped shards). ``SKYTPU_LOAD_WORKERS`` overrides; default min(8,
    cpu count). 1 disables threading."""
    env = os.environ.get('SKYTPU_LOAD_WORKERS')
    if env:
        return max(1, int(env))
    return min(8, os.cpu_count() or 1)


def _for_each_tensor(path: str,
                     process: Callable[[str, torch.Tensor], None]) -> None:
    """Apply ``process(key, tensor)`` to every tensor of the checkpoint
    with :func:`load_workers` threads. A tensor is a view of the mapped
    shard, read from disk as ``process`` copies it out, so the extra
    host memory is what ``process`` keeps. ``process`` must be
    thread-safe for distinct keys (each key is processed once)."""
    from concurrent.futures import ThreadPoolExecutor
    files = [_SafetensorsFile(f) for f in _safetensor_files(path)]
    pairs = [(f, key) for f in files for key in f.keys()]
    workers = load_workers()
    if workers <= 1 or len(pairs) <= 1:
        for f, key in pairs:
            process(key, f.tensor(key))
        return

    def run_shard(shard) -> None:
        for f, key in shard:
            process(key, f.tensor(key))

    shards = [pairs[i::workers] for i in range(workers)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        # list() re-raises the first worker exception.
        list(ex.map(run_shard, [s for s in shards if s]))


def _hf_key_map(cfg: ModelConfig) -> Dict[str, Tuple]:
    """HF tensor suffix (within ``model.layers.{i}.``) -> our leaf path,
    ``('layers', name)``, or ``('layers', name, expert)`` for one
    expert's matrix of a stacked ``[L, E, ...]`` leaf."""
    m = {
        'input_layernorm.weight': ('layers', 'attn_norm'),
        'post_attention_layernorm.weight': ('layers', 'ffn_norm'),
        'self_attn.q_proj.weight': ('layers', 'wq'),
        'self_attn.k_proj.weight': ('layers', 'wk'),
        'self_attn.v_proj.weight': ('layers', 'wv'),
        'self_attn.o_proj.weight': ('layers', 'wo'),
    }
    if cfg.qkv_bias:
        m.update({
            'self_attn.q_proj.bias': ('layers', 'bq'),
            'self_attn.k_proj.bias': ('layers', 'bk'),
            'self_attn.v_proj.bias': ('layers', 'bv'),
        })
    if cfg.is_moe:
        m['block_sparse_moe.gate.weight'] = ('layers', 'router')
        for e in range(cfg.n_experts):
            ep = f'block_sparse_moe.experts.{e}.'
            m[ep + 'w1.weight'] = ('layers', 'moe_gate', e)
            m[ep + 'w3.weight'] = ('layers', 'moe_up', e)
            m[ep + 'w2.weight'] = ('layers', 'moe_down', e)
    else:
        m['mlp.gate_proj.weight'] = ('layers', 'w_gate')
        m['mlp.up_proj.weight'] = ('layers', 'w_up')
        m['mlp.down_proj.weight'] = ('layers', 'w_down')
    return m


def _transform(leaf: Tuple, w: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """HF [out, in] Linear -> our input-major layout (+ head reshapes),
    as a view of ``w`` where the layout allows (the caller's copy into
    its stacked buffer is then the only one)."""
    name = leaf[1]
    hd = cfg.head_dim
    if name in ('attn_norm', 'ffn_norm'):
        return w
    if name == 'bq':
        return w.reshape(cfg.n_heads, hd)
    if name in ('bk', 'bv'):
        return w.reshape(cfg.n_kv_heads, hd)
    if name == 'wq':
        return w.t().reshape(cfg.dim, cfg.n_heads, hd)
    if name in ('wk', 'wv'):
        return w.t().reshape(cfg.dim, cfg.n_kv_heads, hd)
    if name == 'wo':
        return w.t().reshape(cfg.n_heads, hd, cfg.dim)
    # Router [E, d] -> [d, E]; every FFN matrix, dense or one expert's:
    # [out, in] -> [in, out].
    return w.t()


def _check_quantize(quantize: Optional[str]) -> None:
    if quantize not in (None, 'int8', 'int4'):
        raise ValueError(f'unknown quantize mode {quantize!r}')


def load_hf_params(path: str, cfg: ModelConfig,
                   quantize: Optional[str] = None, *,
                   device: DeviceLike = 'cuda',
                   cut: Optional[Callable] = None) -> Params:
    """Load an HF checkpoint directory into the stacked-layer param dict
    on ``device``.

    Each layer tensor is copied (transposed where the layout needs it)
    straight into a preallocated ``[n_layers, ...]`` host buffer (one
    expert's into its row of ``[n_layers, n_experts, ...]``) in its
    final dtype, or, under ``quantize='int8'``/``'int4'``, quantized as
    it arrives into code and scale buffers (int4 packs the dense leaves;
    expert leaves stay int8): host memory peaks near one copy of the
    loaded tree. Matmul weights take ``cfg.dtype``, norms and biases
    fp32; a tied ``embed`` and the router are never quantized. Every
    expected tensor must be present (a missing layer tensor would
    otherwise load as zeros).

    ``cut(path, leaf, layer=False)`` (a serving mesh rank's
    ``parallel.mesh.leaf_cutter``) keeps that rank's shard of each
    tensor as it is read, so the buffers hold the shard only."""
    _check_quantize(quantize)           # before streaming gigabytes
    dev = resolve_device(device)
    key_map = _hf_key_map(cfg)
    L = cfg.n_layers
    axes = quantization.REDUCE_AXES
    group = quantization.int4_group_size() if quantize == 'int4' else 0
    stacked: Dict[str, Any] = {}        # layer-leaf name -> buffer(s)
    top: Dict[str, Any] = {}
    seen = set()
    # Buffer row writes are disjoint per key; the shared-dict mutations
    # (buffer allocation, the seen set) take the lock.
    lock = threading.Lock()

    def dtype_of(name: str) -> torch.dtype:
        return torch.float32 if name in FP32_KEYS else cfg.dtype

    def keep(path, w, layer=False):
        return w if cut is None else cut(path, w, layer)

    def top_leaf(name: str, w: torch.Tensor) -> Any:
        if quantize is not None and name in axes:
            return keep((name,), quantization.quantize_slice(
                name, w, quantize, group, cfg.dtype))
        # Never a view of the file.
        return keep((name,), w).to(dtype_of(name), copy=True)

    def rows(name: str, lead: Tuple[int, ...], like) -> Any:
        """The stacked buffer(s) of leaf ``name``, allocated on first
        use with leading dims ``lead`` from a first slice ``like`` (a
        tensor, or a quantized leaf's tuple); the caller holds the
        lock."""
        buf = stacked.get(name)
        if buf is None:
            if isinstance(like, QUANT_LEAF_TYPES):
                buf = type(like)(*(torch.empty(lead + tuple(t.shape),
                                               dtype=t.dtype) for t in like))
            else:
                buf = torch.empty(lead + tuple(like.shape),
                                  dtype=dtype_of(name))
            stacked[name] = buf
        return buf

    def process(key: str, w: torch.Tensor) -> None:
        if key in ('model.embed_tokens.weight', 'model.norm.weight',
                   'lm_head.weight'):
            if key == 'lm_head.weight' and cfg.tie_embeddings:
                return
            name, w = {'model.embed_tokens.weight': ('embed', w),
                       'model.norm.weight': ('final_norm', w),
                       'lm_head.weight': ('unembed', w.t())}[key]
            leaf = top_leaf(name, w)
            with lock:
                top[name] = leaf
                seen.add(key)
            return
        if not key.startswith('model.layers.'):
            return
        idx_str, suffix = key[len('model.layers.'):].split('.', 1)
        leaf = key_map.get(suffix)
        if leaf is None:
            return
        name = leaf[1]
        at = (int(idx_str),) + tuple(leaf[2:])      # (layer[, expert])
        lead = (L,) if len(leaf) == 2 else (L, cfg.n_experts)
        w = _transform(leaf, w, cfg)
        if quantize is not None and name in axes:
            if len(leaf) == 3:      # one expert [in, out]: int8, per column
                w = quantization.quantize_array(w, (0,), cfg.dtype)
            else:
                w = quantization.quantize_slice(name, w, quantize, group,
                                                cfg.dtype)
        if len(leaf) == 3 and cut is not None:
            # One expert's slice: cut as the layer's expert stack of one.
            one = (type(w)(*(t[None] for t in w))
                   if isinstance(w, QUANT_LEAF_TYPES) else w[None])
            out = keep(('layers', name), one, True)
            w = (type(out)(*(t[0] for t in out))
                 if isinstance(out, QUANT_LEAF_TYPES) else out[0])
        else:
            w = keep(('layers',) + leaf[1:2], w, True)
        with lock:
            buf = rows(name, lead, w)
            seen.add(key)
        if isinstance(w, QUANT_LEAF_TYPES):
            for dst, t in zip(buf, w):
                dst[at] = t
        else:
            buf[at].copy_(w)

    _for_each_tensor(path, process)

    expected = {'model.embed_tokens.weight', 'model.norm.weight'}
    if not cfg.tie_embeddings:
        expected.add('lm_head.weight')
    for i in range(L):
        for suffix in key_map:
            expected.add(f'model.layers.{i}.{suffix}')
    missing = sorted(expected - seen)
    if missing:
        raise ValueError(
            f'Checkpoint at {path} is missing {len(missing)} tensors, '
            f'first: {missing[:6]}')

    def put(v):
        if isinstance(v, QUANT_LEAF_TYPES):
            return type(v)(*(t.to(dev) for t in v))
        return v.to(dev)

    top_keys, layer_keys = param_keys(cfg)
    params: Params = {k: put(top.pop(k)) for k in top_keys}
    params['layers'] = {k: put(stacked.pop(k)) for k in layer_keys}
    return params


# ------------------------------------------------------------ int8 cache
def _dtype_name(dtype: torch.dtype) -> str:
    """The reference's ``str(jnp.dtype(dtype))`` for a torch dtype."""
    return str(dtype).replace('torch.', '')


def load_checkpoint(path: str, dtype: torch.dtype = torch.bfloat16,
                    name: Optional[str] = None,
                    quantize: Optional[str] = None,
                    use_cache: bool = True, *,
                    device: DeviceLike = 'cuda',
                    cut: Optional[Callable] = None
                    ) -> Tuple[ModelConfig, Params]:
    """One-call import: HF dir -> (ModelConfig, params on ``device``).
    ``cut(cfg)`` gives a serving mesh rank's ``leaf_cutter``: the params
    are then that rank's shard.

    With ``quantize='int8'`` or ``'int4'`` the quantized tree is cached
    next to the checkpoint (``.int8_cache.bin`` or ``.int4_cache.bin`` +
    ``.meta.json``): the first load
    pays the full read and host quantization, later loads map the
    smaller cached tree. A cache whose fingerprint (dtype, shard sizes
    and mtimes) no longer matches is rebuilt; a directory that cannot
    be written just skips the cache.

    Under a mesh (``cut``) a valid cache is mapped and each leaf cut to
    this rank's shard on the host before it is copied to the device, so
    no rank requantizes or holds the whole tree. A mesh load never
    writes the cache (it would need the whole tree, or every rank racing
    to write one file): without a valid cache each rank reads and
    quantizes its shard tensor by tensor (:func:`load_hf_params`), and a
    meshless load of the same directory writes the cache that later
    mesh loads map."""
    _check_quantize(quantize)
    dev = resolve_device(device)
    cfg = config_from_hf(_read_hf_config(path), name=name, dtype=dtype)
    cutter = None if cut is None else cut(cfg)
    cache_file = os.path.join(path, f'.{quantize}_cache.bin')
    fingerprint = _cache_fingerprint(path, dtype)
    if quantize and use_cache and os.path.exists(cache_file):
        try:
            if _read_cache_meta(cache_file) == fingerprint:
                return cfg, _load_int8_cache(cache_file, dev, cut=cutter)
            print(f'[weights] {quantize} cache stale (checkpoint or '
                  'dtype changed); requantizing', flush=True)
        except (OSError, ValueError, KeyError) as e:
            print(f'[weights] {quantize} cache unreadable ({e}); '
                  'reloading', flush=True)
    if cutter is not None:
        return cfg, load_hf_params(path, cfg, quantize=quantize, device=dev,
                                   cut=cutter)
    params = load_hf_params(path, cfg, quantize=quantize, device=dev)
    if quantize and use_cache:
        try:
            _save_int8_cache(cache_file, params, fingerprint)
        except OSError as e:
            print(f'[weights] {quantize} cache not written: {e}',
                  flush=True)
    return cfg, params


def _cache_fingerprint(path: str, dtype: torch.dtype) -> Dict[str, Any]:
    """Validity key of the cache: the requested dtype and the
    size/mtime of every safetensors shard."""
    files = [(os.path.basename(f), os.path.getsize(f),
              int(os.path.getmtime(f)))
             for f in _safetensor_files(path)]
    return {'dtype': _dtype_name(dtype), 'files': files}


def _read_cache_manifest(cache_file: str) -> Optional[Dict[str, Any]]:
    meta_file = cache_file + '.meta.json'
    if not os.path.exists(meta_file):
        return None
    with open(meta_file, encoding='utf-8') as f:
        return json.load(f)


def _read_cache_meta(cache_file: str) -> Optional[Dict[str, Any]]:
    """The saved fingerprint (for staleness checks)."""
    meta = _read_cache_manifest(cache_file)
    if meta is None:
        return None
    fp = meta['fingerprint']
    fp['files'] = [tuple(e) for e in fp.get('files', [])]
    return fp


def _flatten_leaves(params: Params, prefix: str = ''):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _flatten_leaves(v, f'{prefix}{k}/')
        elif isinstance(v, QuantizedWeight):
            yield f'{prefix}{k}.int8', v.int8
            yield f'{prefix}{k}.scale', v.scale
        elif isinstance(v, QuantizedWeight4):
            yield f'{prefix}{k}.int4', v.packed
            yield f'{prefix}{k}.scale', v.scale
        else:
            yield f'{prefix}{k}', v


_CACHE_ALIGN = 128


def _save_int8_cache(cache_file: str, params: Params,
                     fingerprint: Dict[str, Any]) -> None:
    """Flat binary + JSON manifest: each leaf's raw little-endian bytes
    at a 128-byte-aligned offset; bf16 leaves are recorded as uint16
    with a ``view`` tag (numpy has no bf16). The meta file is written
    last, so a save that dies half way never leaves a valid-looking
    cache."""
    manifest = []
    off = 0
    for name, leaf in _flatten_leaves(params):
        view = 'bfloat16' if leaf.dtype == torch.bfloat16 else None
        np_dtype = 'uint16' if view else str(leaf.dtype).replace('torch.',
                                                                 '')
        nbytes = leaf.numel() * leaf.element_size()
        off = (off + _CACHE_ALIGN - 1) // _CACHE_ALIGN * _CACHE_ALIGN
        manifest.append({'name': name, 'dtype': np_dtype, 'view': view,
                         'shape': list(leaf.shape), 'offset': off,
                         'nbytes': int(nbytes)})
        off += nbytes
    tmp = cache_file + '.tmp'
    with open(tmp, 'wb') as f:
        for entry, (_, leaf) in zip(manifest, _flatten_leaves(params)):
            f.seek(entry['offset'])
            t = leaf.detach().cpu().contiguous()
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    os.replace(tmp, cache_file)
    meta_tmp = cache_file + '.meta.json.tmp'
    with open(meta_tmp, 'w', encoding='utf-8') as f:
        json.dump({'version': 2, 'fingerprint': fingerprint,
                   'manifest': manifest}, f)
    os.replace(meta_tmp, cache_file + '.meta.json')


# Manifest dtype -> leaf dtype (bf16 leaves are recorded as uint16).
_CACHE_DTYPES = {'int8': torch.int8, 'uint8': torch.uint8,
                 'uint16': torch.bfloat16, 'float32': torch.float32}


def _load_int8_cache(cache_file: str, device: torch.device,
                     cut: Optional[Callable] = None) -> Params:
    """The cached int8 or int4 tree on ``device`` (the leaf class from
    the ``.int8``/``.int4`` name suffix); leaves are copied from the
    mapped file to the device in parallel. With ``cut`` (a mesh rank's
    ``leaf_cutter``) each leaf, codes and scales together, is cut to
    this rank's shard on the host first, so only the shard is copied
    out of the mapping and to the device."""
    from concurrent.futures import ThreadPoolExecutor
    meta = _read_cache_manifest(cache_file)
    if meta is None or meta.get('version') != 2:
        raise ValueError(f'{cache_file}: no version-2 manifest')
    mm = np.memmap(cache_file, dtype=np.uint8, mode='c')

    def fetch(entry):
        if (entry['dtype'] == 'uint16') != (entry['view'] == 'bfloat16'):
            raise ValueError(f'cache leaf {entry["name"]}: dtype '
                             f'{entry["dtype"]} view {entry["view"]}')
        dtype = _CACHE_DTYPES[entry['dtype']]
        shape = tuple(entry['shape'])
        n = entry['nbytes'] // dtype.itemsize
        if n == 0:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(mm, dtype=dtype, count=n,
                                 offset=entry['offset']).reshape(shape)
        return entry['name'], (t if cut is not None
                               else t.to(device, copy=True))

    with ThreadPoolExecutor(max_workers=load_workers()) as ex:
        flat = dict(ex.map(fetch, meta['manifest']))
    params: Params = {}
    pending: Dict[str, Dict[str, Any]] = {}
    for name, t in flat.items():
        parts = name.split('/')
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        if leaf.endswith(('.int8', '.int4', '.scale')):
            base, field = leaf.rsplit('.', 1)
            slot = pending.setdefault('/'.join(parts[:-1] + [base]),
                                      {'node': node, 'base': base})
            slot[field] = t
        else:
            node[leaf] = t
    for slot in pending.values():
        slot['node'][slot['base']] = (
            QuantizedWeight4(packed=slot['int4'], scale=slot['scale'])
            if 'int4' in slot else
            QuantizedWeight(int8=slot['int8'], scale=slot['scale']))
    if cut is None:
        return params

    def shard(path, node):
        if isinstance(node, dict):
            return {k: shard(path + (k,), v) for k, v in node.items()}
        # A leaf that is whole is still the mapping's view: copy it out.
        leaf = cut(path, node)
        if isinstance(leaf, (QuantizedWeight, QuantizedWeight4)):
            return type(leaf)(*(x.to(device, copy=True) for x in leaf))
        return leaf.to(device, copy=True)
    return shard((), params)


# ---------------------------------------------------------------- export
def hf_config_dict(cfg: ModelConfig,
                   torch_dtype: str = 'float32') -> Dict[str, Any]:
    """The HF ``config.json`` dict for a ModelConfig (the exact inverse
    of :func:`config_from_hf`)."""
    arch = {'llama': 'LlamaForCausalLM', 'gemma': 'GemmaForCausalLM',
            'mixtral': 'MixtralForCausalLM',
            'qwen2': 'Qwen2ForCausalLM'}
    family = ('mixtral' if cfg.is_moe else
              'gemma' if cfg.norm_plus_one else
              'qwen2' if cfg.qkv_bias else 'llama')
    hf_cfg: Dict[str, Any] = {
        'architectures': [arch[family]],
        'model_type': family,
        'hidden_size': cfg.dim,
        'intermediate_size': cfg.ffn_dim,
        'num_hidden_layers': cfg.n_layers,
        'num_attention_heads': cfg.n_heads,
        'num_key_value_heads': cfg.n_kv_heads,
        'head_dim': cfg.head_dim,
        'vocab_size': cfg.vocab_size,
        'max_position_embeddings': cfg.max_seq_len,
        'rope_theta': cfg.rope_theta,
        'rms_norm_eps': cfg.norm_eps,
        'tie_word_embeddings': cfg.tie_embeddings,
        'torch_dtype': torch_dtype,
    }
    if cfg.is_moe:
        hf_cfg.update(num_local_experts=cfg.n_experts,
                      num_experts_per_tok=cfg.n_experts_per_token)
    if family == 'gemma':
        hf_cfg['hidden_act'] = 'gelu_pytorch_tanh'
    return hf_cfg


def save_hf_checkpoint(path: str, cfg: ModelConfig, params: Params) -> None:
    """Inverse of :func:`load_hf_params` for unquantized trees (dense or
    MoE): ``config.json`` + ``model.safetensors`` in HF layout, every
    tensor fp32, streamed one tensor at a time."""
    os.makedirs(path, exist_ok=True)
    hd = cfg.head_dim
    lp = params['layers']

    def f32(t) -> torch.Tensor:
        if isinstance(t, QUANT_LEAF_TYPES):
            raise NotImplementedError('save_hf_checkpoint takes dense '
                                      'trees; quantized leaves are not '
                                      'exported')
        return t.detach().to('cpu', torch.float32)

    entries: List[Tuple[str, Callable[[], torch.Tensor]]] = [
        ('model.embed_tokens.weight', lambda: f32(params['embed'])),
        ('model.norm.weight', lambda: f32(params['final_norm']))]
    if not cfg.tie_embeddings:
        entries.append(('lm_head.weight',
                        lambda: f32(params['unembed']).t()))
    per_layer = [
        ('input_layernorm.weight', lambda i: f32(lp['attn_norm'][i])),
        ('post_attention_layernorm.weight',
         lambda i: f32(lp['ffn_norm'][i])),
        ('self_attn.q_proj.weight',
         lambda i: f32(lp['wq'][i]).reshape(cfg.dim, cfg.n_heads * hd).t()),
        ('self_attn.k_proj.weight',
         lambda i: f32(lp['wk'][i]).reshape(cfg.dim,
                                            cfg.n_kv_heads * hd).t()),
        ('self_attn.v_proj.weight',
         lambda i: f32(lp['wv'][i]).reshape(cfg.dim,
                                            cfg.n_kv_heads * hd).t()),
        ('self_attn.o_proj.weight',
         lambda i: f32(lp['wo'][i]).reshape(cfg.n_heads * hd, cfg.dim).t()),
    ]
    if cfg.qkv_bias:
        per_layer += [
            ('self_attn.q_proj.bias',
             lambda i: f32(lp['bq'][i]).reshape(cfg.n_heads * hd)),
            ('self_attn.k_proj.bias',
             lambda i: f32(lp['bk'][i]).reshape(cfg.n_kv_heads * hd)),
            ('self_attn.v_proj.bias',
             lambda i: f32(lp['bv'][i]).reshape(cfg.n_kv_heads * hd)),
        ]
    if cfg.is_moe:
        per_layer.append(('block_sparse_moe.gate.weight',
                          lambda i: f32(lp['router'][i]).t()))
        for e in range(cfg.n_experts):
            ep = f'block_sparse_moe.experts.{e}.'
            per_layer += [
                (ep + 'w1.weight',
                 lambda i, e=e: f32(lp['moe_gate'][i, e]).t()),
                (ep + 'w3.weight', lambda i, e=e: f32(lp['moe_up'][i, e]).t()),
                (ep + 'w2.weight',
                 lambda i, e=e: f32(lp['moe_down'][i, e]).t())]
    else:
        per_layer += [
            ('mlp.gate_proj.weight', lambda i: f32(lp['w_gate'][i]).t()),
            ('mlp.up_proj.weight', lambda i: f32(lp['w_up'][i]).t()),
            ('mlp.down_proj.weight', lambda i: f32(lp['w_down'][i]).t()),
        ]
    for i in range(cfg.n_layers):
        entries += [(f'model.layers.{i}.{suffix}',
                     lambda fn=fn, i=i: fn(i)) for suffix, fn in per_layer]
    shapes = hf_shapes(cfg)
    specs = [(k, torch.float32, shapes[k]) for k, _ in entries]
    with _SafetensorsWriter(os.path.join(path, 'model.safetensors'),
                            specs) as w:
        for k, fn in entries:
            w.write(k, fn())
    with open(os.path.join(path, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump(hf_config_dict(cfg, torch_dtype='float32'), f, indent=2)


def hf_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of an HF checkpoint for ``cfg`` -> its shape."""
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    out = {'model.embed_tokens.weight': (cfg.vocab_size, d),
           'model.norm.weight': (d,)}
    if not cfg.tie_embeddings:
        out['lm_head.weight'] = (cfg.vocab_size, d)
    layer = {'input_layernorm.weight': (d,),
             'post_attention_layernorm.weight': (d,),
             'self_attn.q_proj.weight': (q, d),
             'self_attn.k_proj.weight': (kv, d),
             'self_attn.v_proj.weight': (kv, d),
             'self_attn.o_proj.weight': (d, q)}
    if cfg.is_moe:
        layer['block_sparse_moe.gate.weight'] = (cfg.n_experts, d)
        for e in range(cfg.n_experts):
            ep = f'block_sparse_moe.experts.{e}.'
            layer.update({ep + 'w1.weight': (f, d), ep + 'w3.weight': (f, d),
                          ep + 'w2.weight': (d, f)})
    else:
        layer.update({'mlp.gate_proj.weight': (f, d),
                      'mlp.up_proj.weight': (f, d),
                      'mlp.down_proj.weight': (d, f)})
    if cfg.qkv_bias:
        layer.update({'self_attn.q_proj.bias': (q,),
                      'self_attn.k_proj.bias': (kv,),
                      'self_attn.v_proj.bias': (kv,)})
    for i in range(cfg.n_layers):
        out.update({f'model.layers.{i}.{k}': v for k, v in layer.items()})
    return out
