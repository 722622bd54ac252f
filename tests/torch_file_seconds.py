"""Seconds per test file from a pytest junit XML, heaviest first.

    python tests/torch_file_seconds.py RUN.xml [MORE.xml ...] [--top N]

Each testcase's time (setup, call and teardown) is summed by file: under
`-n 6 --dist loadfile` one worker runs each whole file, so a file's sum
is the time it held its worker. Prints a markdown table (file, tests,
seconds; one seconds column per XML, matched by file) and the sum of
each column.
"""

import argparse
import xml.etree.ElementTree as ET
from collections import defaultdict


def file_seconds(path):
    """{test file: (tests, seconds)} of one junit XML."""
    out = defaultdict(lambda: [0, 0.0])
    for case in ET.parse(path).getroot().iter('testcase'):
        mod = case.get('classname', '').split('.')
        # classname is dotted: tests.test_x[.Class]; keep the module
        name = next((m for m in mod if m.startswith('test_')), mod[-1])
        out[name + '.py'][0] += 1
        out[name + '.py'][1] += float(case.get('time', 0.0))
    return {k: tuple(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('xml', nargs='+')
    ap.add_argument('--top', type=int, default=0)
    a = ap.parse_args()
    runs = [file_seconds(p) for p in a.xml]
    files = sorted(set().union(*runs),
                   key=lambda f: -runs[0].get(f, (0, 0.0))[1])
    if a.top:
        files = files[:a.top]
    print('| file | tests | ' + ' | '.join(f's ({p})' for p in a.xml)
          + ' |')
    print('|---|---|' + '---|' * len(runs))
    for f in files:
        n = max(r.get(f, (0, 0.0))[0] for r in runs)
        print(f'| `{f}` | {n} | ' + ' | '.join(
            f'{r[f][1]:.2f}' if f in r else '—' for r in runs) + ' |')
    print('| all | ' + str(max(sum(v[0] for v in r.values()) for r in runs))
          + ' | ' + ' | '.join(f'{sum(v[1] for v in r.values()):.2f}'
                              for r in runs) + ' |')


if __name__ == '__main__':
    main()
