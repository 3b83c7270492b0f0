"""The reference's YOLOv11-n and AdaFace IR-Net as plain torch modules.

A frozen copy of ``prpe_tpu_torch/tools/reference_nets.py`` (itself the
transcription of ``training/yolopt/nets/nn.py:28-347`` and
``libs/net_adaface.py:144-337`` in the original repository), so that later
changes to the program cannot move the yardstick. The state-dict key names
are the reference modules' own; ``benchmark/weights.py`` maps them to the
program's. Only the module classes are copied: decoding lives in
``cascade.py``.
"""

import torch

from benchmark.reference.precision import lowp

class TC(torch.nn.Module):
    """conv+BN(+SiLU) block; state-dict keys '<name>.conv.*', '<name>.norm.*'."""

    def __init__(self, i, o, k=1, s=1, p=0, g=1, act=True):
        super().__init__()
        self.conv = torch.nn.Conv2d(i, o, k, s, p, groups=g, bias=False)
        self.norm = torch.nn.BatchNorm2d(o, eps=0.001, momentum=0.03)
        self.act = torch.nn.SiLU() if act else torch.nn.Identity()

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class TRes(torch.nn.Module):
    def __init__(self, ch, e=0.5):
        super().__init__()
        self.conv1 = TC(ch, int(ch * e), 3, p=1)
        self.conv2 = TC(int(ch * e), ch, 3, p=1)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class TCSPM(torch.nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.conv1 = TC(i, o // 2)
        self.conv2 = TC(i, o // 2)
        self.conv3 = TC(o, o)
        self.res_m = torch.nn.Sequential(TRes(o // 2, 1.0), TRes(o // 2, 1.0))

    def forward(self, x):
        return self.conv3(torch.cat([self.res_m(self.conv1(x)), self.conv2(x)], 1))


class TCSP(torch.nn.Module):
    def __init__(self, i, o, n, csp_inner, r):
        super().__init__()
        c = o // r
        self.conv1 = TC(i, 2 * c)
        self.conv2 = TC((2 + n) * c, o)
        mk = (lambda: TCSPM(c, c)) if csp_inner else (lambda: TRes(c))
        self.res_m = torch.nn.ModuleList(mk() for _ in range(n))

    def forward(self, x):
        ys = list(self.conv1(x).chunk(2, 1))
        for m in self.res_m:
            ys.append(m(ys[-1]))
        return self.conv2(torch.cat(ys, 1))


class TSPP(torch.nn.Module):
    def __init__(self, ch, k=5):
        super().__init__()
        self.conv1 = TC(ch, ch // 2)
        self.conv2 = TC(ch * 2, ch)
        self.pool = torch.nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x):
        x = self.conv1(x)
        a = self.pool(x)
        b = self.pool(a)
        return self.conv2(torch.cat([x, a, b, self.pool(b)], 1))


class TAttn(torch.nn.Module):
    """qkv-packed conv attention; keys qkv/conv1(pos)/conv2(proj)."""

    def __init__(self, ch, nh):
        super().__init__()
        self.nh, self.dh = nh, ch // nh
        self.dk = self.dh // 2
        self.qkv = TC(ch, ch + 2 * self.dk * nh, act=False)
        self.conv1 = TC(ch, ch, 3, p=1, g=ch, act=False)
        self.conv2 = TC(ch, ch, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(x).view(b, self.nh, 2 * self.dk + self.dh, h * w)
        q, k, v = qkv.split([self.dk, self.dk, self.dh], dim=2)
        q, k, v = lowp(q, self), lowp(k, self), lowp(v, self)
        attn = torch.softmax(q.transpose(-2, -1) @ k * self.dk**-0.5, dim=-1)
        y = (v @ lowp(attn, self).transpose(-2, -1)).view(b, c, h, w)
        return self.conv2(y + self.conv1(v.reshape(b, c, h, w)))


class TPSABlock(torch.nn.Module):
    def __init__(self, ch, nh):
        super().__init__()
        self.conv1 = TAttn(ch, nh)
        self.conv2 = torch.nn.Sequential(TC(ch, ch * 2), TC(ch * 2, ch, act=False))

    def forward(self, x):
        x = x + self.conv1(x)
        return x + self.conv2(x)


class TPSA(torch.nn.Module):
    def __init__(self, ch, n):
        super().__init__()
        self.conv1 = TC(ch, ch)
        self.conv2 = TC(ch, ch)
        self.res_m = torch.nn.Sequential(
            *(TPSABlock(ch // 2, max(1, ch // 128)) for _ in range(n))
        )

    def forward(self, x):
        a, b = self.conv1(x).chunk(2, 1)
        return self.conv2(torch.cat([a, self.res_m(b)], 1))


class TDarkNet(torch.nn.Module):
    def __init__(self, w, d, c):
        super().__init__()
        self.p1 = torch.nn.Sequential(TC(w[0], w[1], 3, 2, 1))
        self.p2 = torch.nn.Sequential(
            TC(w[1], w[2], 3, 2, 1), TCSP(w[2], w[3], d[0], c[0], 4)
        )
        self.p3 = torch.nn.Sequential(
            TC(w[3], w[3], 3, 2, 1), TCSP(w[3], w[4], d[1], c[0], 4)
        )
        self.p4 = torch.nn.Sequential(
            TC(w[4], w[4], 3, 2, 1), TCSP(w[4], w[4], d[2], c[1], 2)
        )
        self.p5 = torch.nn.Sequential(
            TC(w[4], w[5], 3, 2, 1),
            TCSP(w[5], w[5], d[3], c[1], 2),
            TSPP(w[5]),
            TPSA(w[5], d[4]),
        )

    def forward(self, x):
        p3 = self.p3(self.p2(self.p1(x)))
        p4 = self.p4(p3)
        return p3, p4, self.p5(p4)


class TDarkFPN(torch.nn.Module):
    def __init__(self, w, d, c):
        super().__init__()
        self.up = torch.nn.Upsample(scale_factor=2)
        self.h1 = TCSP(w[4] + w[5], w[4], d[5], c[0], 2)
        self.h2 = TCSP(w[4] + w[4], w[3], d[5], c[0], 2)
        self.h3 = TC(w[3], w[3], 3, 2, 1)
        self.h4 = TCSP(w[3] + w[4], w[4], d[5], c[0], 2)
        self.h5 = TC(w[4], w[4], 3, 2, 1)
        self.h6 = TCSP(w[4] + w[5], w[5], d[5], c[1], 2)

    def forward(self, feats):
        p3, p4, p5 = feats
        p4 = self.h1(torch.cat([self.up(p5), p4], 1))
        p3 = self.h2(torch.cat([self.up(p4), p3], 1))
        p4 = self.h4(torch.cat([self.h3(p3), p4], 1))
        p5 = self.h6(torch.cat([self.h5(p4), p5], 1))
        return p3, p4, p5


class THead(torch.nn.Module):
    """Raw maps per level (B, 4 * 16 + nc, h, w); ``cascade.py`` decodes them."""

    def __init__(self, nc, filters, ch=16):
        super().__init__()
        box = max(64, filters[0] // 4)
        cls = max(80, filters[0], nc)
        self.box = torch.nn.ModuleList(
            torch.nn.Sequential(
                TC(f, box, 3, p=1), TC(box, box, 3, p=1),
                torch.nn.Conv2d(box, 4 * ch, 1),
            )
            for f in filters
        )
        self.cls = torch.nn.ModuleList(
            torch.nn.Sequential(
                TC(f, f, 3, p=1, g=f), TC(f, cls),
                TC(cls, cls, 3, p=1, g=cls), TC(cls, cls),
                torch.nn.Conv2d(cls, nc, 1),
            )
            for f in filters
        )

    def forward(self, feats):
        return [
            torch.cat([b(f), c(f)], 1) for f, b, c in zip(feats, self.box, self.cls)
        ]


class TYolo(torch.nn.Module):
    def __init__(self, nc=80, w=(3, 16, 32, 64, 128, 256),
                 d=(1, 1, 1, 1, 1, 1), c=(False, True)):
        super().__init__()
        self.net = TDarkNet(w, d, c)
        self.fpn = TDarkFPN(w, d, c)
        self.head = THead(nc, (w[3], w[4], w[5]))

    def forward(self, x):
        return self.head(list(self.fpn(self.net(x))))


def _ir_block(in_ch, depth, stride, se):
    """torch BasicBlockIR(+SE) with the reference's child names."""
    blk = torch.nn.Module()
    if in_ch == depth:
        blk.shortcut_layer = torch.nn.MaxPool2d(1, stride)
    else:
        blk.shortcut_layer = torch.nn.Sequential(
            torch.nn.Conv2d(in_ch, depth, 1, stride, bias=False),
            torch.nn.BatchNorm2d(depth),
        )
    res = torch.nn.Sequential(
        torch.nn.BatchNorm2d(in_ch),
        torch.nn.Conv2d(in_ch, depth, 3, 1, 1, bias=False),
        torch.nn.BatchNorm2d(depth),
        torch.nn.PReLU(depth),
        torch.nn.Conv2d(depth, depth, 3, stride, 1, bias=False),
        torch.nn.BatchNorm2d(depth),
    )
    if se:
        se_mod = torch.nn.Module()
        se_mod.fc1 = torch.nn.Conv2d(depth, depth // 16, 1, bias=False)
        se_mod.fc2 = torch.nn.Conv2d(depth // 16, depth, 1, bias=False)
        se_mod.forward = lambda x, m=se_mod: x * torch.sigmoid(
            m.fc2(torch.relu(m.fc1(x.mean((2, 3), keepdim=True))))
        )
        res.add_module("se_block", se_mod)
    blk.res_layer = res
    blk.forward = lambda x, b=blk: b.res_layer(x) + b.shortcut_layer(x)
    return blk


class TIRNet(torch.nn.Module):
    _STAGES = {
        18: ((64, 2), (128, 2), (256, 2), (512, 2)),
        50: ((64, 3), (128, 4), (256, 14), (512, 3)),
    }

    def __init__(self, num_layers=50, se=False, in_ch=3):
        super().__init__()
        self.input_layer = torch.nn.Sequential(
            torch.nn.Conv2d(in_ch, 64, 3, 1, 1, bias=False),
            torch.nn.BatchNorm2d(64),
            torch.nn.PReLU(64),
        )
        blocks = []
        prev = 64
        for depth, n in self._STAGES[num_layers]:
            for u in range(n):
                blocks.append(_ir_block(prev, depth, 2 if u == 0 else 1, se))
                prev = depth
        self.body = torch.nn.Sequential(*blocks)
        self.output_layer = torch.nn.Sequential(
            torch.nn.BatchNorm2d(512),
            torch.nn.Dropout(0.4),
            torch.nn.Flatten(),
            torch.nn.Linear(512 * 7 * 7, 512),
            torch.nn.BatchNorm1d(512, affine=False),
        )

    def forward(self, x):
        x = self.output_layer(self.body(self.input_layer(x)))
        norm = torch.norm(x, 2, 1, True)
        return x / norm, norm
