"""Seeded-defect and clean sources of the JAX analyzer's tests, for the
port's parity test (tests/test_torch_analysis.py).

Each case is (id, {file name: source}) as the JAX test hands it to
`engine.analyze_source(s)`: the id names the JAX test file and test it
comes from (tests/test_static_analysis.py, test_analysis_v2.py,
test_concurrency_analysis.py, test_effects_analysis.py,
test_lifecycle_analysis.py), and the sources keep its `h2o3_tpu`
paths; the parity test maps them to `h2o3_tpu_torch` for the port.
"""

CASES = [
    ('static_analysis.test_r001_detects_jit_lambda_in_function_body.1',
     {'<fixture>': 'import jax\n'
                   'def hot(x):\n'
                   '    return jax.jit(lambda a: a + 1)(x)\n'}),
    ('static_analysis.test_r001_detects_per_call_jit_of_nested_def.1',
     {'<fixture>': 'import jax\n'
                   'def hot(x):\n'
                   '    def body(a):\n'
                   '        return a * 2\n'
                   '    return jax.jit(body)(x)\n'}),
    ('static_analysis.test_r001_clean_on_module_level_jit_and_cached_jit.1',
     {'<fixture>': 'import jax\n'
                   'from h2o3_tpu.parallel.mrtask import cached_jit\n'
                   '@jax.jit\n'
                   'def fine(a):\n'
                   '    return a + 1\n'
                   'def also_fine(x):\n'
                   '    return cached_jit(lambda a: a + 1)(x)\n'}),
    ('static_analysis.test_r002_detects_host_sync_inside_traced_fn.1',
     {'<fixture>': 'import jax\n'
                   'import numpy as np\n'
                   '@jax.jit\n'
                   'def f(x):\n'
                   '    return np.asarray(x).sum()\n'}),
    ('static_analysis.test_r002_detects_barrier_inside_span_block.1',
     {'<fixture>': 'import jax\n'
                   'from h2o3_tpu.obs.timeline import span\n'
                   'def hot(x):\n'
                   "    with span('score.dispatch'):\n"
                   '        jax.block_until_ready(x)\n'
                   '    return x\n'}),
    ('static_analysis.test_r003_detects_bare_mutation_of_locked_attr.1',
     {'<fixture>': 'import threading\n'
                   'class C:\n'
                   '    def __init__(self):\n'
                   '        self._lock = threading.Lock()\n'
                   '        self._items = []\n'
                   '    def safe(self, v):\n'
                   '        with self._lock:\n'
                   '            self._items.append(v)\n'
                   '    def racy(self, v):\n'
                   '        self._items.append(v)\n'}),
    ('static_analysis.test_r004_detects_impurity_under_trace.1',
     {'<fixture>': 'import jax\n'
                   'import time\n'
                   '@jax.jit\n'
                   'def f(x):\n'
                   '    return x * time.time()\n'}),
    ('static_analysis.test_r004_detects_impurity_under_trace.2',
     {'<fixture>': 'import jax\n'
                   'import numpy as np\n'
                   '@jax.jit\n'
                   'def f(x):\n'
                   '    return x + np.random.normal()\n'}),
    ('static_analysis.test_r005_detects_duplicate_and_nonliteral_declarations.1',
     {'<fixture>': 'from h2o3_tpu.obs import metrics as _om\n'
                   "A = _om.counter('h2o3_fixture_dup_total', 'first')\n"
                   "B = _om.counter('h2o3_fixture_dup_total', 'second')\n"}),
    ('static_analysis.test_r005_detects_duplicate_and_nonliteral_declarations.2',
     {'<fixture>': 'from h2o3_tpu.obs import metrics as _om\n'
                   'def make(suffix):\n'
                   "    return _om.counter('h2o3_' + suffix)\n"}),
    ('static_analysis.test_r005_detects_inconsistent_label_sets.1',
     {'<fixture>': 'from h2o3_tpu.obs import metrics as _om\n'
                   "C = _om.counter('h2o3_fixture_labels_total', 'x')\n"
                   'def a():\n'
                   "    C.inc(reason='x')\n"
                   'def b():\n'
                   "    C.inc(reason='x')\n"
                   'def c():\n'
                   '    C.inc()\n'}),
    ('static_analysis.test_r005_sees_instance_attribute_emissions.1',
     {'<fixture>': 'from h2o3_tpu.obs import metrics as _om\n'
                   'class Eng:\n'
                   '    def __init__(self):\n'
                   "        self._g = _om.REGISTRY.gauge('h2o3_fixture_attr', "
                   "'x')\n"
                   '    def a(self):\n'
                   "        self._g.set(1.0, slo='s')\n"
                   '    def b(self):\n'
                   '        self._g.set(0.0)\n'}),
    ('static_analysis.test_r006_detects_group_signature_drift.1',
     {'h2o3_tpu/api/fixture_routes.py': 'import re\n'
                                        'def _h_one(h, a):\n'
                                        '    pass\n'
                                        'ROUTES = [\n'
                                        '    '
                                        "(re.compile(r'/3/Thing/([^/]+)/([^/]+)'), "
                                        "'GET', _h_one),\n"
                                        ']\n'}),
    ('static_analysis.test_r006_detects_duplicate_and_missing_handler.1',
     {'h2o3_tpu/api/fixture_routes.py': 'import re\n'
                                        'def _h_ok(h):\n'
                                        '    pass\n'
                                        'ROUTES = [\n'
                                        "    (re.compile(r'/3/Same'), 'GET', "
                                        '_h_ok),\n'
                                        "    (re.compile(r'/3/Same'), 'GET', "
                                        '_h_ok),\n'
                                        "    (re.compile(r'/3/Gone'), 'GET', "
                                        '_h_missing),\n'
                                        ']\n'}),
    ('static_analysis.test_inline_suppression_waives_finding.1',
     {'<fixture>': 'import jax\n'
                   'def hot(x):\n'
                   '    # h2o3-ok: R001 fixture: intentionally waived\n'
                   '    return jax.jit(lambda a: a + 1)(x)\n'}),
    ('static_analysis.test_baseline_grandfathers_by_fingerprint.1',
     {'<fixture>': 'import jax\n'
                   'def hot(x):\n'
                   '    return jax.jit(lambda a: a + 1)(x)\n'}),
    ('static_analysis.test_baseline_grandfathers_by_fingerprint.2',
     {'<fixture>': 'import jax\n'
                   'def hot(x):\n'
                   '    return jax.jit(lambda a: a + 1)(x)\n'}),
    ('static_analysis.test_r005_ignores_exemplar_kwarg.1',
     {'<fixture>': 'from h2o3_tpu.obs import metrics as _om\n'
                   "H = _om.histogram('h2o3_fixture_ex_seconds', 'x')\n"
                   'def a(tid):\n'
                   "    H.observe(0.1, exemplar=tid, route='/3/X')\n"
                   'def b():\n'
                   "    H.observe(0.2, route='/3/X')\n"}),
    ('static_analysis.test_r005_flags_exemplar_kwarg_on_counter.1',
     {'<fixture>': 'from h2o3_tpu.obs import metrics as _om\n'
                   "C = _om.counter('h2o3_fixture_ex_total', 'x')\n"
                   'def a(tid):\n'
                   "    C.inc(exemplar=tid, route='/3/X')\n"
                   'def b():\n'
                   "    C.inc(route='/3/X')\n"}),
    ('static_analysis.test_r011_detects_duplicate_span_declarations.1',
     {'h2o3_tpu/fixture_spans.py': 'from h2o3_tpu.obs.timeline import span as '
                                   '_span\n'
                                   'def a():\n'
                                   "    with _span('fixture.phase'):\n"
                                   '        pass\n'
                                   'def b():\n'
                                   "    with _span('fixture.phase'):\n"
                                   '        pass\n'}),
    ('static_analysis.test_r011_detects_nonliteral_span_name.1',
     {'h2o3_tpu/fixture_spans.py': 'from h2o3_tpu.obs.timeline import span\n'
                                   'def a(key):\n'
                                   "    with span('fixture.' + key):\n"
                                   '        pass\n'}),
    ('static_analysis.test_r011_relaxed_for_tests.1',
     {'tests/test_fixture.py': 'from h2o3_tpu.obs.timeline import span\n'
                               'def test_x(n):\n'
                               "    with span('t.' + str(n)):\n"
                               '        pass\n'}),
    ('static_analysis.test_r012_detects_print_and_bare_getlogger.1',
     {'h2o3_tpu/fixture_prints.py': 'import logging\n'
                                    'def work():\n'
                                    "    print('done')\n"
                                    "    lg = logging.getLogger('mine')\n"
                                    "    lg.info('x')\n"}),
    ('static_analysis.test_r012_clean_on_structured_logger.1',
     {'h2o3_tpu/fixture_prints.py': 'from h2o3_tpu.utils import log as _log\n'
                                    'def work():\n'
                                    "    _log.info('done %s', 1)\n"
                                    '    '
                                    "_log.get_logger('sub').warning('x')\n"}),
    ('static_analysis.test_r012_exempts_cli_main_modules_and_tests.1',
     {'h2o3_tpu/analysis/__main__.py': 'def main():\n'
                                       "    print('usage: ...')\n"}),
    ('static_analysis.test_r012_exempts_cli_main_modules_and_tests.2',
     {'tests/test_fixture.py': "def main():\n    print('usage: ...')\n"}),
    ('static_analysis.test_r012_exempts_cli_main_modules_and_tests.3',
     {'h2o3_tpu/core/fixture.py': "def main():\n    print('usage: ...')\n"}),
    ('static_analysis.test_r012_inline_suppression.1',
     {'h2o3_tpu/fixture_prints.py': 'def main():\n'
                                    "    print('report')   # h2o3-ok: R012 "
                                    'CLI output\n'}),
    ('static_analysis.test_r013_detects_unbounded_socket_waits.1',
     {'h2o3_tpu/fixture_socks.py': 'import socket\n'
                                   'def serve(port):\n'
                                   '    srv = socket.socket()\n'
                                   "    srv.bind(('0.0.0.0', port))\n"
                                   '    srv.listen(1)\n'
                                   '    conn, addr = srv.accept()\n'
                                   '    data = conn.recv(4096)\n'
                                   'def dial(host):\n'
                                   '    s = socket.create_connection((host, '
                                   '80))\n'
                                   '    s.recv(1)\n'}),
    ('static_analysis.test_r013_clean_when_bounded.1',
     {'h2o3_tpu/fixture_socks.py': 'import socket\n'
                                   'def serve(port):\n'
                                   '    srv = socket.socket()\n'
                                   '    srv.settimeout(1.0)\n'
                                   '    conn, addr = srv.accept()\n'
                                   'def dial(host):\n'
                                   '    s = socket.create_connection((host, '
                                   '80), timeout=5.0)\n'
                                   '    return s.recv(1)\n'
                                   'def helper(sock):\n'
                                   '    return sock.recv(64)\n'}),
    ('static_analysis.test_r013_suppression_and_test_relaxation.1',
     {'h2o3_tpu/fixture_socks.py': 'import socket\n'
                                   'def dial(host):\n'
                                   '    s = socket.create_connection((host, '
                                   '80))   # h2o3-ok: R013 formation wait is '
                                   'bounded by the caller\n'
                                   '    s.settimeout(1.0)\n'}),
    ('static_analysis.test_r013_suppression_and_test_relaxation.2',
     {'tests/test_fixture.py': 'import socket\n'
                               'def t():\n'
                               "    s = socket.create_connection(('h', 1))\n"}),
    ('static_analysis.test_r014_detects_unguarded_jit_decorator.1',
     {'h2o3_tpu/serving/fixture_deco.py': 'import jax\n'
                                          '@jax.jit\n'
                                          'def scorer(x):\n'
                                          '    return x * 2\n'}),
    ('static_analysis.test_r014_detects_unguarded_jit_decorator.2',
     {'h2o3_tpu/serving/fixture_deco.py': 'import jax\n'
                                          'from h2o3_tpu.parallel import '
                                          'compat as _compat\n'
                                          '@_compat.guard_collective\n'
                                          '@jax.jit\n'
                                          'def scorer(x):\n'
                                          '    return x * 2\n'}),
    ('static_analysis.test_r014_detects_partial_jit_spelling.1',
     {'h2o3_tpu/serving/fixture_partial.py': 'import functools\n'
                                             'import jax\n'
                                             '@functools.partial(jax.jit, '
                                             "static_argnames=('depth',))\n"
                                             'def scorer(x, *, depth):\n'
                                             '    return x * depth\n'
                                             'def build(fn):\n'
                                             '    return '
                                             'functools.partial(jax.jit, '
                                             'donate_argnums=(0,))(fn)\n'}),
    ('static_analysis.test_r014_detects_partial_jit_spelling.2',
     {'h2o3_tpu/serving/fixture_partial.py': 'import functools\n'
                                             'import jax\n'
                                             'from h2o3_tpu.parallel import '
                                             'compat as _compat\n'
                                             '@_compat.guard_collective\n'
                                             '@functools.partial(jax.jit, '
                                             "static_argnames=('depth',))\n"
                                             'def scorer(x, *, depth):\n'
                                             '    return x * depth\n'
                                             'def build(fn):\n'
                                             '    return '
                                             '_compat.guard_collective(\n'
                                             '        '
                                             'functools.partial(jax.jit, '
                                             'donate_argnums=(0,))(fn))\n'}),
    ('static_analysis.test_r014_clean_when_routed_through_the_guard.1',
     {'h2o3_tpu/serving/fixture_cache.py': 'import jax\n'
                                           'from h2o3_tpu.parallel import '
                                           'compat as _compat\n'
                                           'def build(fn):\n'
                                           '    return '
                                           '_compat.guard_collective(jax.jit(fn))\n'
                                           'def build2(fn):\n'
                                           '    return '
                                           '_compat.guarded_jit(fn, '
                                           'donate_argnums=(0,))\n'}),
    ('static_analysis.test_r014_scope_is_serving_and_parallel_only.1',
     {'h2o3_tpu/models/fixture_algo.py': 'import jax\n'
                                         'def b(fn):\n'
                                         '    return jax.jit(fn)\n'}),
    ('static_analysis.test_r014_scope_is_serving_and_parallel_only.2',
     {'h2o3_tpu/parallel/compat.py': 'import jax\n'
                                     'def b(fn):\n'
                                     '    return jax.jit(fn)\n'}),
    ('static_analysis.test_r014_suppression.1',
     {'h2o3_tpu/serving/fixture_cache.py': 'import jax\n'
                                           'def host_only(fn):\n'
                                           '    return jax.jit(fn)   # '
                                           'h2o3-ok: R014 host-side scalar '
                                           'probe, no collectives\n'}),
    ('analysis_v2.test_r007_sees_lock_inversion_behind_subclass_override.1',
     {'h2o3_tpu/fxv2/base.py': 'import threading\n'
                               'class Base:\n'
                               '    def __init__(self):\n'
                               '        self._la = threading.Lock()\n'
                               '        self._lb = threading.Lock()\n'
                               '    def op(self):\n'
                               '        pass\n'
                               '    def caller(self):\n'
                               '        with self._la:\n'
                               '            self.op()\n',
      'h2o3_tpu/fxv2/sub.py': 'from h2o3_tpu.fxv2.base import Base\n'
                              'class Sub(Base):\n'
                              '    def op(self):\n'
                              '        with self._lb:\n'
                              '            pass\n'
                              '    def other(self):\n'
                              '        with self._lb:\n'
                              '            with self._la:\n'
                              '                pass\n'}),
    ('analysis_v2.test_r008_sees_blocking_behind_subclass_override.1',
     {'h2o3_tpu/fxv2/b.py': 'import threading\n'
                            'class Base:\n'
                            '    def __init__(self):\n'
                            '        self._lk = threading.Lock()\n'
                            '    def hook(self):\n'
                            '        pass\n'
                            '    def caller(self):\n'
                            '        with self._lk:\n'
                            '            self.hook()\n',
      'h2o3_tpu/fxv2/s.py': 'import time\n'
                            'from h2o3_tpu.fxv2.b import Base\n'
                            'class Sub(Base):\n'
                            '    def hook(self):\n'
                            '        time.sleep(5)\n'}),
    ('analysis_v2.test_duck_seam_resolves_single_hierarchy_private_names.1',
     {'h2o3_tpu/fxv2/m.py': 'import threading\n'
                            '_L = threading.Lock()\n'
                            'class ModelFix:\n'
                            '    def _fx_score(self, x):\n'
                            '        return x\n'
                            'class SubModelFix(ModelFix):\n'
                            '    def _fx_score(self, x):\n'
                            '        import time\n'
                            '        time.sleep(1)\n'
                            '        return x\n'
                            'def dispatch(model, x):\n'
                            '    with _L:\n'
                            '        return model._fx_score(x)\n'}),
    ('analysis_v2.test_duck_seam_refuses_multi_hierarchy_names.1',
     {'h2o3_tpu/fxv2/m2.py': 'import threading\n'
                             '_L = threading.Lock()\n'
                             'class A:\n'
                             '    def _fx_thing(self):\n'
                             '        import time\n'
                             '        time.sleep(1)\n'
                             'class B:\n'
                             '    def _fx_thing(self):\n'
                             '        pass\n'
                             'def go(obj):\n'
                             '    with _L:\n'
                             '        obj._fx_thing()\n'}),
    ('analysis_v2.test_r015_detects_sync_hidden_behind_helper_in_span.1',
     {'h2o3_tpu/fx_r015.py': 'import jax\n'
                             'from h2o3_tpu.obs.timeline import span\n'
                             'def helper(x):\n'
                             '    return jax.block_until_ready(x)\n'
                             'def hot(x):\n'
                             "    with span('fx.dispatch'):\n"
                             '        return helper(x)\n'}),
    ('analysis_v2.test_r015_transitive_through_two_hops.1',
     {'h2o3_tpu/fx_r015b.py': 'from h2o3_tpu.obs.timeline import span\n'
                              'def deep(x):\n'
                              '    return x.item()\n'
                              'def middle(x):\n'
                              '    return deep(x)\n'
                              'def hot(x):\n'
                              "    with span('fx.two_hop'):\n"
                              '        return middle(x)\n'}),
    ('analysis_v2.test_r015_serving_path_allows_explicit_staging_transfers.1',
     {'h2o3_tpu/serving/fx_stage.py': 'from jax import device_get\n'
                                      'def stage(x):\n'
                                      '    return device_get(x)\n'
                                      'def dispatch(x):\n'
                                      '    return stage(x)\n'}),
    ('analysis_v2.test_r015_serving_path_allows_explicit_staging_transfers.2',
     {'h2o3_tpu/serving/fx_leak.py': 'def leak(x):\n'
                                     '    return x.tolist()\n'
                                     'def dispatch(x):\n'
                                     '    return leak(x)\n'}),
    ('analysis_v2.test_r015_suppression_and_test_relaxation.1',
     {'h2o3_tpu/fx_r015c.py': 'import jax\n'
                              'from h2o3_tpu.obs.timeline import span\n'
                              'def helper(x):\n'
                              '    return jax.block_until_ready(x)\n'
                              'def hot(x):\n'
                              "    with span('fx.ok'):\n"
                              '        return helper(x)   # h2o3-ok: R015 the '
                              'sync IS the work\n'}),
    ('analysis_v2.test_r016_detects_time_mutating_replayed_state.1',
     {'h2o3_tpu/fx_r016.py': 'import time\n'
                             'class FixtureBroadcaster:\n'
                             '    def __init__(self):\n'
                             '        self._state = {}\n'
                             '    def handle(self, req):\n'
                             "        self._state[req['k']] = time.time()\n"}),
    ('analysis_v2.test_r016_detects_set_iteration_feeding_state.1',
     {'h2o3_tpu/fx_r016b.py': 'class FixtureBroadcaster:\n'
                              '    def __init__(self):\n'
                              '        self._order = []\n'
                              '    def handle(self, keys):\n'
                              '        for k in set(keys):\n'
                              '            self._order.append(k)\n'}),
    ('analysis_v2.test_r016_clean_shapes.1',
     {'h2o3_tpu/fx_r016c.py': 'import random\n'
                              'import time\n'
                              'class FixtureBroadcaster:\n'
                              '    def __init__(self):\n'
                              '        self._state = {}\n'
                              '        self._order = []\n'
                              '    def handle(self, req, keys):\n'
                              "        self._state[req['k']] = req['t']\n"
                              '        for k in sorted(set(keys)):\n'
                              '            self._order.append(k)\n'
                              '        time.sleep(random.random() * 0.1)\n'}),
    ('analysis_v2.test_r016_reaches_through_call_graph_from_handler_roots.1',
     {'h2o3_tpu/fx_r016d.py': 'import re\n'
                              'import time\n'
                              'class Store:\n'
                              '    def __init__(self):\n'
                              '        self._d = {}\n'
                              '    def stamp(self):\n'
                              "        self._d['t'] = time.time()\n"
                              'S = Store()\n'
                              'def _h_mutate(h):\n'
                              '    S.stamp()\n'
                              'ROUTES = [\n'
                              "    (re.compile(r'/3/Fx'), 'POST', "
                              '_h_mutate),\n'
                              ']\n'}),
    ('analysis_v2.test_r016_catches_the_real_session_id_bug_shape.1',
     {'h2o3_tpu/fx_sess.py': 'import re\n'
                             'import time\n'
                             '_SID_COUNTER = [0]\n'
                             'def _h_sessions_post(h):\n'
                             '    from h2o3_tpu.api import server as _srv\n'
                             '    _SID_COUNTER[0] += 1\n'
                             '    sid = '
                             "f'_sid{_SID_COUNTER[0]}_{int(time.time())}'\n"
                             '    _srv._sessions[sid] = object()\n'
                             'def build_routes():\n'
                             '    R = re.compile\n'
                             '    return [\n'
                             "        (R(r'/3/Sessions'), 'POST', "
                             '_h_sessions_post),\n'
                             '    ]\n'}),
    ('analysis_v2.test_r016_suppression_and_test_relaxation.1',
     {'tests/test_fx.py': 'import time\n'
                          'class FixtureBroadcaster:\n'
                          '    def __init__(self):\n'
                          '        self._state = {}\n'
                          '    def handle(self, req):\n'
                          "        self._state[req['k']] = time.time()\n"}),
    ('analysis_v2.test_r017_detects_direct_reads.1',
     {'h2o3_tpu/fx_r017.py': 'import os\n'
                             'def a():\n'
                             "    return os.environ.get('H2O3_FX_A', '1')\n"
                             'def b():\n'
                             "    return int(os.environ['H2O3_FX_B'])\n"
                             'def c():\n'
                             "    return os.getenv('H2O3_FX_C')\n"}),
    ('analysis_v2.test_r017_detects_duplicate_and_nonliteral_declarations.1',
     {'h2o3_tpu/fx_r017b.py': 'from h2o3_tpu.utils.env import env_int\n'
                              "A = env_int('H2O3_FX_DUP', 5)\n"
                              "B = env_int('H2O3_FX_DUP', 7)\n"
                              'def c(name):\n'
                              '    return env_int(name, 1)\n'
                              'def d(fallback):\n'
                              "    return env_int('H2O3_FX_D', fallback)\n"
                              'def e():\n'
                              "    return env_int('H2O3_FX_E')\n"}),
    ('analysis_v2.test_r017_clean_accessor_usage.1',
     {'h2o3_tpu/fx_r017c.py': 'from h2o3_tpu.utils import env as _env\n'
                              'from h2o3_tpu.utils.env import env_bool, '
                              'env_float, env_str\n'
                              'def a():\n'
                              "    return _env.env_int('H2O3_FX_OK', 1 << "
                              '20)\n'
                              'def b():\n'
                              "    return env_float('H2O3_FX_OK2', 2.5)\n"
                              'def c():\n'
                              "    return env_bool('H2O3_FX_OK3')\n"
                              'def d():\n'
                              "    return env_str('H2O3_FX_OK4', '') or "
                              'a()\n'}),
    ('analysis_v2.test_r017_suppression_and_test_relaxation.1',
     {'h2o3_tpu/fx_r017d.py': 'import os\n'
                              'def a():\n'
                              "    return os.environ.get('H2O3_FX_W')   # "
                              'h2o3-ok: R017 fixture waiver\n'}),
    ('concurrency_analysis.test_r007_detects_single_module_ab_ba_cycle.1',
     {'h2o3_tpu/fix_ab.py': 'import threading\n'
                            'class C:\n'
                            '    def __init__(self):\n'
                            '        self._la = threading.Lock()\n'
                            '        self._lb = threading.Lock()\n'
                            '    def m1(self):\n'
                            '        with self._la:\n'
                            '            with self._lb:\n'
                            '                pass\n'
                            '    def m2(self):\n'
                            '        with self._lb:\n'
                            '            with self._la:\n'
                            '                pass\n'}),
    ('concurrency_analysis.test_r007_detects_cross_module_cycle_via_call_graph.1',
     {'h2o3_tpu/x/aa.py': 'import threading\n'
                          'from h2o3_tpu.x import bb\n'
                          '_LA = threading.Lock()\n'
                          'def fa():\n'
                          '    with _LA:\n'
                          '        bb.fb_inner()\n'
                          'def fa_inner():\n'
                          '    with _LA:\n'
                          '        pass\n',
      'h2o3_tpu/x/bb.py': 'import threading\n'
                          'from h2o3_tpu.x import aa\n'
                          '_LB = threading.Lock()\n'
                          'def fb():\n'
                          '    with _LB:\n'
                          '        aa.fa_inner()\n'
                          'def fb_inner():\n'
                          '    with _LB:\n'
                          '        pass\n'}),
    ('concurrency_analysis.test_r007_clean_on_consistent_global_order.1',
     {'h2o3_tpu/fix_ok.py': 'import threading\n'
                            'class C:\n'
                            '    def __init__(self):\n'
                            '        self._la = threading.Lock()\n'
                            '        self._lb = threading.Lock()\n'
                            '    def m1(self):\n'
                            '        with self._la:\n'
                            '            with self._lb:\n'
                            '                pass\n'
                            '    def m2(self):\n'
                            '        with self._la:\n'
                            '            with self._lb:\n'
                            '                pass\n'}),
    ('concurrency_analysis.test_r008_detects_timeoutless_queue_get_under_lock.1',
     {'h2o3_tpu/fix_q.py': 'import threading\n'
                           'import queue\n'
                           'class Q:\n'
                           '    def __init__(self):\n'
                           '        self._lock = threading.Lock()\n'
                           '        self._q = queue.Queue()\n'
                           '    def bad(self):\n'
                           '        with self._lock:\n'
                           '            return self._q.get()\n'}),
    ('concurrency_analysis.test_r007_detects_cycle_via_manual_acquire_release.1',
     {'h2o3_tpu/fix_ma.py': 'import threading\n'
                            'class C:\n'
                            '    def __init__(self):\n'
                            '        self._la = threading.Lock()\n'
                            '        self._lb = threading.Lock()\n'
                            '    def m1(self):\n'
                            '        self._la.acquire()\n'
                            '        try:\n'
                            '            with self._lb:\n'
                            '                pass\n'
                            '        finally:\n'
                            '            self._la.release()\n'
                            '    def m2(self):\n'
                            '        with self._lb:\n'
                            '            self._la.acquire()\n'
                            '            self._la.release()\n'}),
    ('concurrency_analysis.test_r008_detects_blocking_between_acquire_and_release.1',
     {'h2o3_tpu/fix_mb.py': 'import threading\n'
                            'import time\n'
                            'class C:\n'
                            '    def __init__(self):\n'
                            '        self._lock = threading.Lock()\n'
                            '    def bad(self):\n'
                            '        self._lock.acquire()\n'
                            '        time.sleep(5)\n'
                            '        self._lock.release()\n'
                            '    def ok(self):\n'
                            '        self._lock.acquire()\n'
                            '        self._lock.release()\n'
                            '        time.sleep(5)\n'}),
    ('concurrency_analysis.test_r007_trylock_acquire_adds_no_order_edge.1',
     {'h2o3_tpu/fix_mt.py': 'import threading\n'
                            'class C:\n'
                            '    def __init__(self):\n'
                            '        self._la = threading.Lock()\n'
                            '        self._lb = threading.Lock()\n'
                            '    def m1(self):\n'
                            '        with self._la:\n'
                            '            with self._lb:\n'
                            '                pass\n'
                            '    def m2(self):\n'
                            '        with self._lb:\n'
                            '            if '
                            'self._la.acquire(blocking=False):\n'
                            '                self._la.release()\n'}),
    ('concurrency_analysis.test_r008_bounded_wait_is_clean.1',
     {'h2o3_tpu/fix_b.py': 'import threading\n'
                           'class Q:\n'
                           '    def __init__(self):\n'
                           '        self._lock = threading.Lock()\n'
                           '        self._ev = threading.Event()\n'
                           '    def ok(self):\n'
                           '        with self._lock:\n'
                           '            return self._ev.wait(timeout=2.0)\n'}),
    ('concurrency_analysis.test_r008_detects_blocking_reached_through_call_chain.1',
     {'h2o3_tpu/fix_c.py': 'import threading\n'
                           'class B:\n'
                           '    def __init__(self, sock):\n'
                           '        self._lock = threading.Lock()\n'
                           '        self._sock = sock\n'
                           '    def _pump(self):\n'
                           '        return self._sock.recv(65536)\n'
                           '    def bad(self):\n'
                           '        with self._lock:\n'
                           '            return self._pump()\n'}),
    ('concurrency_analysis.test_r008_detects_device_sync_under_lock.1',
     {'h2o3_tpu/fix_d.py': 'import threading\n'
                           'import jax\n'
                           'class S:\n'
                           '    def __init__(self):\n'
                           '        self._lock = threading.Lock()\n'
                           '    def bad(self, x):\n'
                           '        with self._lock:\n'
                           '            return jax.device_get(x)\n'}),
    ('concurrency_analysis.test_r009_detects_read_after_donate.1',
     {'h2o3_tpu/fix_e.py': 'import jax\n'
                           'def f(x):\n'
                           '    return x * 2\n'
                           'def hot(buf):\n'
                           '    g = jax.jit(f, donate_argnums=(0,))\n'
                           '    out = g(buf)\n'
                           '    return out + buf.sum()\n'}),
    ('concurrency_analysis.test_r009_rebind_after_donate_is_clean.1',
     {'h2o3_tpu/fix_f.py': 'import jax\n'
                           'def f(x):\n'
                           '    return x * 2\n'
                           'def fine(buf):\n'
                           '    g = jax.jit(f, donate_argnums=(0,))\n'
                           '    out = g(buf)\n'
                           '    buf = out * 1\n'
                           '    return buf\n'}),
    ('concurrency_analysis.test_r009_tracks_donating_factory_functions.1',
     {'h2o3_tpu/fix_g.py': 'import jax\n'
                           'def _build():\n'
                           '    def _score(raw):\n'
                           '        return raw + 1\n'
                           '    return jax.jit(_score, donate_argnums=(0,))\n'
                           'def serve(staged):\n'
                           '    fn = _build()\n'
                           '    out = fn(staged)\n'
                           '    return out, staged.shape\n'}),
    ('concurrency_analysis.test_r010_detects_non_daemon_unjoined_thread.1',
     {'h2o3_tpu/fix_h.py': 'import threading\n'
                           'def leak():\n'
                           '    threading.Thread(target=print).start()\n'}),
    ('concurrency_analysis.test_r010_daemon_or_joined_thread_is_clean.1',
     {'h2o3_tpu/fix_i.py': 'import threading\n'
                           'def ok():\n'
                           '    threading.Thread(target=print, '
                           'daemon=True).start()\n'
                           'def ok2():\n'
                           '    t = threading.Thread(target=print)\n'
                           '    t.start()\n'
                           '    t.join(timeout=5)\n'}),
    ('concurrency_analysis.test_r010_detects_discarded_future_and_unmanaged_executor.1',
     {'h2o3_tpu/fix_j.py': 'from concurrent.futures import '
                           'ThreadPoolExecutor\n'
                           'def pool_leak():\n'
                           '    pool = ThreadPoolExecutor(2)\n'
                           '    pool.submit(print)\n'}),
    ('concurrency_analysis.test_r002_detects_host_fetch_inside_span_block.1',
     {'<fixture>': 'from h2o3_tpu.obs.timeline import span\n'
                   'from h2o3_tpu.parallel.mrtask import host_fetch\n'
                   'def hot(x):\n'
                   "    with span('score.dispatch'):\n"
                   '        return host_fetch(x)\n'}),
    ('concurrency_analysis.test_relaxed_profile_waives_r001_r004_in_tests_only.1',
     {'h2o3_tpu/fix_k.py': 'import jax\n'
                           'import time\n'
                           '@jax.jit\n'
                           'def f(x):\n'
                           '    return x * time.time()\n'
                           'def hot(x):\n'
                           '    return jax.jit(lambda a: a + 1)(x)\n'}),
    ('concurrency_analysis.test_relaxed_profile_waives_r001_r004_in_tests_only.2',
     {'tests/fix_k.py': 'import jax\n'
                        'import time\n'
                        '@jax.jit\n'
                        'def f(x):\n'
                        '    return x * time.time()\n'
                        'def hot(x):\n'
                        '    return jax.jit(lambda a: a + 1)(x)\n'}),
    ('concurrency_analysis.test_relaxed_profile_keeps_concurrency_rules_in_tests.1',
     {'tests/fix_l.py': 'import threading\n'
                        'def leak():\n'
                        '    threading.Thread(target=print).start()\n'}),
    ('effects_analysis.test_r018_flags_exempt_route_mutating_replicated_state.1',
     {'h2o3_tpu/fx18/srv.py': 'import re\n'
                              'from h2o3_tpu.core.kvstore import DKV\n'
                              'def _is_static_path(path):\n'
                              "    return path.startswith('/flow') or path == "
                              "'/ping'\n"
                              'def _h_flow_asset(req):\n'
                              "    DKV.put('asset_meta', req)\n"
                              'def _h_models(req):\n'
                              "    DKV.put('m', req)\n"
                              'ROUTES = [\n'
                              "    (re.compile(r'/flow/index\\.html'), 'GET', "
                              '_h_flow_asset),\n'
                              "    (re.compile(r'/3/Models'), 'GET', "
                              '_h_models),\n'
                              ']\n'}),
    ('effects_analysis.test_r018_reaches_through_helper_calls.1',
     {'h2o3_tpu/fx18b/srv.py': 'import re\n'
                               'from h2o3_tpu.fx18b.store import stash\n'
                               'def _is_obs_path(path):\n'
                               "    return path in ('/metrics', "
                               "'/3/Timeline')\n"
                               'def _h_metrics(req):\n'
                               "    stash('scrape', req)\n"
                               "ROUTES = [(re.compile(r'/metrics'), 'GET', "
                               '_h_metrics)]\n',
      'h2o3_tpu/fx18b/store.py': 'from h2o3_tpu.core.kvstore import DKV\n'
                                 'def stash(key, v):\n'
                                 '    DKV.put(key, v)\n'}),
    ('effects_analysis.test_r019_interprocedural_pid_through_helper_module.1',
     {'h2o3_tpu/fx19/bcast.py': 'from h2o3_tpu.fx19.ident import node_tag\n'
                                'class FixtureBroadcaster:\n'
                                '    def __init__(self):\n'
                                '        self._state = {}\n'
                                '    def handle(self, req):\n'
                                "        self._state[req['k']] = node_tag()\n",
      'h2o3_tpu/fx19/ident.py': 'import os\n'
                                'def node_tag():\n'
                                "    return 'node-%d' % os.getpid()\n"}),
    ('effects_analysis.test_r019_direct_hostname_store.1',
     {'h2o3_tpu/fx19b.py': 'import socket\n'
                           'class FixtureBroadcaster:\n'
                           '    def __init__(self):\n'
                           '        self._state = {}\n'
                           '    def handle(self, req):\n'
                           "        self._state['host'] = "
                           'socket.gethostname()\n'}),
    ('effects_analysis.test_r019_environ_read_is_divergence_but_census_accessor_is_not.1',
     {'h2o3_tpu/fx19c.py': 'import os\n'
                           'class FixtureBroadcaster:\n'
                           '    def __init__(self):\n'
                           '        self._state = {}\n'
                           '    def handle(self, req):\n'
                           "        self._state['r'] = "
                           "os.environ.get('SOME_ROLE')\n"}),
    ('effects_analysis.test_r019_host_local_sinks_are_not_flagged.1',
     {'h2o3_tpu/obs/fx19e.py': 'import os\n'
                               'class FixtureBroadcaster:\n'
                               '    def __init__(self):\n'
                               '        self._state = {}\n'
                               '    def handle(self, req):\n'
                               "        self._state['pid'] = os.getpid()\n"}),
    ('effects_analysis.test_r020_flags_unhandled_send_and_dead_handler_arm.1',
     {'h2o3_tpu/fx20/chan.py': 'def poll(bc):\n'
                               "    bc.collect('metricz')\n"
                               "    bc.collect('ping')\n"
                               'def _collect_local(op):\n'
                               "    if op == 'ping':\n"
                               '        return 1\n'
                               "    if op == 'stats':\n"
                               '        return 2\n'
                               "    return {'error': 'unknown'}\n"}),
    ('effects_analysis.test_r020_prefix_families_and_variable_ops_pair.1',
     {'h2o3_tpu/fx20b/chan.py': 'import json\n'
                                'def poll(bc, tid, q):\n'
                                "    bc.collect(f'trace:{tid}')\n"
                                "    op = 'logs:search:' + json.dumps(q)\n"
                                '    bc.collect(op)\n'
                                'def _collect_local(op):\n'
                                "    if op.startswith(('trace:', "
                                "'logs:search:')):\n"
                                '        return 1\n'
                                "    return {'error': 'unknown'}\n"}),
    ('effects_analysis.test_r020_scoped_run_with_one_endpoint_stays_quiet.1',
     {'h2o3_tpu/fx20c/send_only.py': 'def poll(bc):\n'
                                     "    bc.collect('orphan_op')\n"}),
    ('effects_analysis.test_r021_flags_phantom_read_and_orphan_write.1',
     {'h2o3_tpu/fx21.py': 'import numpy as np\n'
                          'def save(path, d, m):\n'
                          '    np.savez(path, data=d, mask=m)\n'
                          'def load(path):\n'
                          '    z = np.load(path)\n'
                          "    return z['data'], z['extra']\n"}),
    ('effects_analysis.test_r021_membership_guard_and_dict_payload_pair_clean.1',
     {'h2o3_tpu/fx21b.py': 'import numpy as np\n'
                           'def save(path, d, m):\n'
                           "    arrays = {'data': d}\n"
                           "    arrays['mask'] = m\n"
                           '    np.savez(path, **arrays)\n'
                           'def load(path):\n'
                           '    z = np.load(path)\n'
                           "    m = z['mask'] if 'mask' in z.files else None\n"
                           "    return z['data'], m\n"}),
    ('effects_analysis.test_r021_dynamic_keys_make_the_format_open.1',
     {'h2o3_tpu/fx21c.py': 'import numpy as np\n'
                           'def save(path, cols):\n'
                           "    np.savez(path, **{f'd{i}': c for i, c in "
                           'enumerate(cols)})\n'
                           'def load(path, j):\n'
                           '    z = np.load(path)\n'
                           "    return z[f'd{j}']\n"}),
    ('effects_analysis.test_r021_suppression_and_test_relaxation.1',
     {'tests/test_fx21.py': 'import numpy as np\n'
                            'def save(path, d, m):\n'
                            '    np.savez(path, data=d, mask=m)\n'
                            'def load(path):\n'
                            '    z = np.load(path)\n'
                            "    return z['data'], z['extra']\n"}),
    ('effects_analysis.test_finding_fingerprints_survive_whitespace_shift.1',
     {'h2o3_tpu/fx19/bcast.py': 'from h2o3_tpu.fx19.ident import node_tag\n'
                                'class FixtureBroadcaster:\n'
                                '    def __init__(self):\n'
                                '        self._state = {}\n'
                                '    def handle(self, req):\n'
                                "        self._state[req['k']] = node_tag()\n",
      'h2o3_tpu/fx19/ident.py': 'import os\n'
                                'def node_tag():\n'
                                "    return 'node-%d' % os.getpid()\n"}),
    ('lifecycle_analysis.test_r022_flags_statement_between_acquire_and_finally.1',
     {'h2o3_tpu/fx22/mb.py': 'import time\n'
                             'from h2o3_tpu.serving import qos as _qos\n'
                             'def dispatch(batch, total):\n'
                             "    took = _qos.GATE.acquire('p', total)\n"
                             '    t0 = time.perf_counter()\n'
                             '    try:\n'
                             '        return len(batch)\n'
                             '    finally:\n'
                             '        _qos.GATE.release(took)\n'}),
    ('lifecycle_analysis.test_r022_clean_with_falsy_guard_before_try.1',
     {'h2o3_tpu/fx22c/mb.py': 'from h2o3_tpu.serving import qos as _qos\n'
                              'def dispatch(total):\n'
                              "    took = _qos.GATE.acquire('p', total)\n"
                              '    if not took:\n'
                              '        return 0\n'
                              '    try:\n'
                              '        return 1\n'
                              '    finally:\n'
                              '        _qos.GATE.release(took)\n'}),
    ('lifecycle_analysis.test_r022_flags_branch_path_leak_inside_try.1',
     {'h2o3_tpu/fx22d/mb.py': 'from h2o3_tpu.serving import qos as _qos\n'
                              'def dispatch(total, fast):\n'
                              "    took = _qos.GATE.acquire('p', total)\n"
                              '    if fast:\n'
                              '        _qos.GATE.release(took)\n'
                              '        return 1\n'
                              '    return 0\n'}),
    ('lifecycle_analysis.test_r022_gauge_without_remove_is_flagged.1',
     {'h2o3_tpu/fx22g/obs.py': 'from h2o3_tpu.obs.metrics import gauge\n'
                               "G = gauge('h2o3_fx22_depth', 'fixture "
                               "per-entity gauge')\n"
                               'def on_update(key, n):\n'
                               '    G.set(n, key=key)\n'}),
    ('lifecycle_analysis.test_r023_flags_broad_swallow_of_control_exception.1',
     {'h2o3_tpu/serving/fx23.py': 'from h2o3_tpu.serving.qos import '
                                  'RateLimited\n'
                                  'def admit(principal):\n'
                                  "    if principal == 'flood':\n"
                                  "        raise RateLimited('p', 1.0)\n"
                                  'def handle(req):\n'
                                  '    try:\n'
                                  "        admit(req['principal'])\n"
                                  '    except Exception:\n'
                                  '        return None\n'}),
    ('lifecycle_analysis.test_r023_quiet_when_no_control_exception_can_arrive.1',
     {'h2o3_tpu/serving/fx23d.py': 'def heartbeat(sock):\n'
                                   '    try:\n'
                                   "        sock.send(b'ping')\n"
                                   '    except Exception:\n'
                                   '        return False\n'
                                   '    return True\n'}),
    ('lifecycle_analysis.test_r024_flags_discarded_token.1',
     {'h2o3_tpu/fx24/jobs.py': 'from h2o3_tpu.serving import qos as _qos\n'
                               'def submit(job):\n'
                               '    _qos.acquire_job_slot()\n'
                               '    return job\n'}),
    ('lifecycle_analysis.test_r024_flags_returner_wrapper_whose_caller_leaks.1',
     {'h2o3_tpu/fx24b/jobs.py': 'from h2o3_tpu.serving import qos as _qos\n'
                                'def take_slot():\n'
                                '    return _qos.acquire_job_slot()\n'
                                'def submit(job):\n'
                                '    take_slot()\n'
                                '    return job\n'}),
    ('lifecycle_analysis.test_r024_clean_when_caller_closes.1',
     {'h2o3_tpu/fx24c/jobs.py': 'from h2o3_tpu.serving import qos as _qos\n'
                                'def take_slot():\n'
                                '    return _qos.acquire_job_slot()\n'
                                'def submit(job):\n'
                                '    tok = take_slot()\n'
                                '    try:\n'
                                '        return job\n'
                                '    finally:\n'
                                '        _qos.release_job_slot(tok)\n'}),
    ('lifecycle_analysis.test_r025_flags_callback_in_scorer.1',
     {'h2o3_tpu/fx25/score.py': 'import jax\n'
                                'def _score_with_params(params, X):\n'
                                '    jax.pure_callback(lambda a: a, X, X)\n'
                                '    return X\n'}),
    ('lifecycle_analysis.test_r025_flags_concretization_and_traced_branch.1',
     {'h2o3_tpu/fx25b/score.py': 'def _score_with_params(params, X):\n'
                                 '    lo = float(X)\n'
                                 '    if X > 0:\n'
                                 '        return lo\n'
                                 '    return 0.0\n'}),
    ('lifecycle_analysis.test_r025_flags_module_device_const_capture.1',
     {'h2o3_tpu/fx25c/score.py': 'import jax.numpy as jnp\n'
                                 'BIAS = jnp.zeros((4,))\n'
                                 'def _score_with_params(params, X):\n'
                                 '    return X + BIAS\n'}),
    ('lifecycle_analysis.test_r025_static_shapes_are_exempt.1',
     {'h2o3_tpu/fx25d/score.py': 'import functools\n'
                                 'import jax\n'
                                 '@functools.partial(jax.jit, '
                                 "static_argnames=('link',))\n"
                                 'def _score_with_params(params, X, link, '
                                 'offset=None):\n'
                                 '    if offset is None:\n'
                                 '        n = int(X.shape[0])\n'
                                 "    if link == 'logit':\n"
                                 '        return X * 2\n'
                                 "    if link in ('identity', 'log'):\n"
                                 '        return X\n'
                                 '    return X + 1\n'}),
    ('lifecycle_analysis.test_r025_reaches_scorer_helpers_through_calls.1',
     {'h2o3_tpu/fx25e/score.py': 'def _linkapply(eta):\n'
                                 '    if eta > 0:\n'
                                 '        return eta\n'
                                 '    return -eta\n'
                                 'def _score_with_params(params, X):\n'
                                 '    return _linkapply(X)\n'}),
]
